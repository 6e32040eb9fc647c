"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


READS_AXIS = "d"
"""The single mesh axis: read shards / k-mer hash slices.  The pipeline
is embarrassingly data-parallel plus one all-to-all, so a 1-D mesh is
the natural layout (SURVEY.md §3.4)."""


def make_mesh(n_devices: int = 0) -> Mesh:
    """A 1-D mesh over the first n_devices visible devices (0 = all),
    ordered by process: each process's devices form one contiguous
    block of the axis, which process-local data placement and the
    evidence routing (parallel/multihost.py) rely on."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if n_devices > 0:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (READS_AXIS,))
