"""The device guard, the compile-cache placement and the nvidia-smi
parser (utils/device.py, utils/jaxcache.py)."""

from pathlib import Path

import jax
import pytest

from shannon_tpu.utils import device as device_mod
from shannon_tpu.utils.device import parse_nvidia_smi_csv, require_gpu
from shannon_tpu.utils.jaxcache import DEFAULT_DIR, enable_compilation_cache

REPO = Path(__file__).resolve().parent.parent


def test_guard_passes_with_explicit_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    require_gpu()


@pytest.mark.parametrize("platforms", [None, "", "cuda,cpu", "cpu,cuda"])
def test_guard_raises_off_gpu(monkeypatch, platforms):
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()


def test_guard_passes_on_gpu(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    require_gpu()


def test_cli_device_backend_uses_guard(monkeypatch, tmp_path):
    from shannon_tpu import cli

    # keep this session's compile cache where it is
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir
    )
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    fasta = tmp_path / "r.fasta"
    fasta.write_text(">r0\nACGTACGTACGTACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cli.main(["-o", str(tmp_path / "out"), "--single", str(fasta)])
    assert not (tmp_path / "out").exists()  # nothing ran


@pytest.fixture
def cache_config():
    """Restore JAX's cache settings after a test changes them."""
    saved = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_honours_env(monkeypatch, tmp_path, cache_config):
    env_dir = tmp_path / "from_env"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))
    got = enable_compilation_cache(tmp_path / "passed")
    assert got == str(env_dir)
    assert jax.config.jax_compilation_cache_dir == str(env_dir)
    assert not (tmp_path / "passed").exists()  # no other dir was made


def test_cache_default_is_fixed_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compilation_cache()
    assert got == str(DEFAULT_DIR) == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    assert enable_compilation_cache() == got  # the same on every call


def test_cache_takes_explicit_path(monkeypatch, tmp_path, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compilation_cache(tmp_path / "c") == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


@pytest.mark.parametrize(
    "text, want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
         [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"},
          {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
        ("Card, with comma, [N/A]\n",
         [{"name": "Card, with comma", "power_limit": "[N/A]"}]),
    ],
)
def test_parse_nvidia_smi_csv(text, want):
    assert parse_nvidia_smi_csv(text) == want


@pytest.mark.parametrize("text", ["no comma here", ", 700.00 W"])
def test_parse_nvidia_smi_csv_rejects(text):
    with pytest.raises(ValueError):
        parse_nvidia_smi_csv(text)


def test_nvidia_smi_missing_raises(monkeypatch):
    monkeypatch.setattr(device_mod.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvidia-smi not found"):
        device_mod.nvidia_smi()


def test_device_info_names_the_backend():
    info = device_mod.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": 8}
    assert device_mod.peak_bytes_in_use() is None  # no allocator stats


def test_program_counter_counts_hits_and_misses():
    import logging

    from shannon_tpu.utils.jaxdiag import ProgramCounter

    c = ProgramCounter()
    log = logging.getLogger("test_program_counter")
    log.addHandler(c)
    log.setLevel(logging.DEBUG)
    try:
        log.debug("PERSISTENT COMPILATION CACHE MISS for 'jit_f' with key %r",
                  "jit_f-abc")
        log.debug("Persistent compilation cache hit for 'jit_g' with key %r",
                  "jit_g-def")
        log.debug("Persistent compilation cache hit for 'jit_f' with key %r",
                  "jit_f-abc")
    finally:
        log.removeHandler(c)
    assert c.keys == {"jit_f-abc", "jit_g-def"}
