"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so the sharded and
collective code paths run without several GPUs (SURVEY.md §5.3).

Tests marked `gpu` need the card.  They skip on the CPU; `chip_smoke.py`
runs them on the GPU in its own process, after setting
SHANNON_TESTS_ON_DEVICE=1, under which this file leaves JAX's backend
and compile cache as the caller set them.
"""

import os

import numpy as np
import pytest

ON_DEVICE = os.environ.get("SHANNON_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_DEVICE:
    # jax.config works even where jax was imported before this file
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    # persistent compile cache: the sharded-pipeline tests compile
    # dozens of programs; caching them across runs cuts suite
    # wall-clock several-fold
    from shannon_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache(
        os.path.join(os.path.dirname(__file__), "..", ".pytest_jax_cache")
    )


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_backend():
    if ON_DEVICE:
        yield
        return
    devs = jax.devices()
    assert devs[0].platform == "cpu", f"tests must run on CPU, got {devs}"
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    yield


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: chip_smoke.py runs the `gpu` tests there"
        )
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
