"""The accelerator the device path runs on, and how a run names it.

The device path is written for an NVIDIA GPU.  `require_gpu` keeps a
run that finds no GPU from quietly falling back to the CPU, where every
time it reports would describe the wrong machine.  The one exception
is `JAX_PLATFORMS=cpu` set explicitly by the caller: that is how the
tests and CPU rehearsals run the device path.
"""

from __future__ import annotations

import os
import shutil
import subprocess

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


def require_gpu() -> None:
    """Raise unless JAX's default backend is the GPU, or the caller set
    JAX_PLATFORMS=cpu explicitly."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"the device path needs a GPU, but JAX's default backend is "
            f"{backend!r}; set JAX_PLATFORMS=cpu to run it on the CPU "
            "on purpose"
        )


def device_info() -> dict:
    """platform, device_kind and count of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def parse_nvidia_smi_csv(text: str) -> list[dict]:
    """Rows of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` as [{"name", "power_limit"}] (one per card).
    The power limit keeps its unit as printed, e.g. "700.00 W"."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        rows.append({"name": name.strip(), "power_limit": limit.strip()})
    return rows


def nvidia_smi() -> tuple[str, list[dict]]:
    """(raw output, parsed rows) of the name/power-limit query; raises
    when nvidia-smi is missing or fails."""
    if shutil.which(NVIDIA_SMI_QUERY[0]) is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        NVIDIA_SMI_QUERY, check=True, capture_output=True, text=True,
        timeout=60,
    ).stdout
    return out.strip(), parse_nvidia_smi_csv(out)


def peak_bytes_in_use() -> int | None:
    """Peak device memory of this process on device 0, or None where
    the backend keeps no allocator statistics (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else int(stats.get("peak_bytes_in_use", 0))
