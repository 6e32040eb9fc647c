"""Multi-process `jax.distributed` execution test (SURVEY.md §8 M5).

Runs scripts/multihost_smoke.py, which launches localhost CPU process
groups (2, then 4 processes), initializes jax.distributed in each, byte-range-ingests half
of one FASTA per process, runs the sharded count over the 2-process
global mesh, and asserts the merged spectrum equals the single-process
oracle.  Skipped when already inside a multi-process context (the
children would fight over the coordinator port).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def test_two_process_jax_distributed_smoke(tmp_path):
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        pytest.skip("already inside a multi-process launch")
    env = {
        k: v
        for k, v in os.environ.items()
        # children must not inherit this pytest session's CPU-mesh flags
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")
    }
    env["SMOKE_RESULT"] = str(tmp_path / "multihost_smoke.json")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "multihost_smoke.py")],
        env=env,
        cwd=tmp_path,  # keep the artifact out of the repo root
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads((tmp_path / "multihost_smoke.json").read_text())
    assert result["ok"] is True
    assert len(result["processes"]) == 2
    assert {p["n_processes"] for p in result["processes"]} == {2}
    # round 4: the smoke now covers the FULL pipeline FASTA to FASTA
    assert result["fasta_parity"] is True
    assert all(p["n_transcripts"] > 0 for p in result["processes"])
