"""chip_smoke.py: which phases a run selects, and its phase helpers
rehearsed at a tiny size on the CPU (the guard is bypassed by the
explicit JAX_PLATFORMS=cpu that conftest sets)."""

import importlib.util
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
SMALL_CAPACITY = ("--kmer-capacity", str(1 << 17))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _keep_cache_dir(monkeypatch):
    # cli.main enables the compile cache: keep this session's directory
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir
    )


@pytest.mark.parametrize(
    "argv, want",
    [
        ([], ("device", "parity", "single", "paired")),
        (["--four"], ("sharded", "multiprocess")),
    ],
)
def test_phase_selection(smoke, argv, want):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true")
    assert smoke.select_phases(ap.parse_args(argv).four) == want
    assert not set(smoke.select_phases(True)) & set(smoke.select_phases(False))
    assert set(want) <= set(smoke.RUNNERS)


def test_main_fails_without_gpu(smoke, capsys):
    """Off the GPU the run fails in phase 1 and prints no result, even
    with JAX_PLATFORMS=cpu set."""
    with pytest.raises(AssertionError, match="not gpu"):
        smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_parity_rehearsal(smoke):
    out = smoke.phase_parity(n_reads=1500, n_transcripts=5,
                             kmer_capacity=1 << 15)
    assert out["transcripts"] > 0 and out["contigs"] > 0


def test_single_rehearsal(smoke, tmp_path):
    res = smoke.phase_single(tmp_path, n_reads=2000, n_transcripts=5,
                             cli_args=SMALL_CAPACITY)
    assert res["recall_exact"] >= smoke.SINGLE_MIN_RECALL
    assert res["n_transcripts"] > 0
    assert res["peak_bytes_in_use"] is None  # the CPU keeps no stats
    assert "spectrum" in res["stages_warm"]


def test_paired_rehearsal(smoke, tmp_path):
    res = smoke.phase_paired(tmp_path, n_pairs=1500, n_transcripts=5,
                             cli_args=SMALL_CAPACITY)
    assert res["recall_exact"] >= smoke.PAIRED_MIN_RECALL
    assert res["pairs"] >= 1500


def test_single_rehearsal_fails_below_recall_floor(smoke, tmp_path):
    with pytest.raises(AssertionError, match="exact recall"):
        smoke.phase_single(tmp_path, n_reads=2000, n_transcripts=5,
                           min_recall=1.01, cli_args=SMALL_CAPACITY)


def test_sharded_rehearsal(smoke, tmp_path):
    """-p 4 == -p 1 through the CLI in one process, on 4 of the CPU
    session's virtual devices."""
    fasta, _truth = smoke.write_single_fasta(tmp_path, 2000, n_transcripts=5)
    res = smoke.phase_sharded(tmp_path, fasta, n_devices=4,
                              cli_args=SMALL_CAPACITY)
    assert res["n_transcripts"] > 0
    assert set(res) == {"n_transcripts", "p4_wall_s", "p1_wall_s"}
