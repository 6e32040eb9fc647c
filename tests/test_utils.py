"""Tests for support utilities: spectrum serialization, compaction
helpers, multihost slicing, timing."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.ops.count import (
    Spectrum,
    spectrum_from_arrays,
    unique_first_sorted,
)
from shannon_tpu.ops.kmers import SENTINEL


def test_spectrum_from_arrays_roundtrip(rng):
    keys = np.unique(rng.integers(0, 1 << 48, size=200).astype(np.uint64))
    counts = rng.integers(1, 100, size=len(keys)).astype(np.int64)
    spec = spectrum_from_arrays(keys, counts)
    d = spec.to_dict()
    assert d == {int(k): int(c) for k, c in zip(keys, counts)}
    assert int(spec.n) == len(keys)
    assert not spec.overflowed()
    with pytest.raises(ValueError):
        spectrum_from_arrays(keys, counts, capacity=len(keys) // 2)


def test_unique_first_sorted():
    hi = jnp.array([0, 0, 0, 1, 1, SENTINEL], dtype=jnp.uint32)
    lo = jnp.array([5, 5, 7, 7, 7, SENTINEL], dtype=jnp.uint32)
    pay = jnp.array([10, 10, 20, 30, 30, 0], dtype=jnp.int32)
    ohi, olo, (op,), n = unique_first_sorted(hi, lo, (pay,), 8)
    assert int(n) == 3
    assert ohi[:3].tolist() == [0, 0, 1]
    assert olo[:3].tolist() == [5, 7, 7]
    assert op[:3].tolist() == [10, 20, 30]
    assert (np.asarray(ohi[3:]) == 0xFFFFFFFF).all()


def test_unique_first_sorted_empty():
    hi = jnp.full(4, SENTINEL, jnp.uint32)
    lo = jnp.full(4, SENTINEL, jnp.uint32)
    _, _, _, n = unique_first_sorted(hi, lo, (jnp.zeros(4, jnp.int32),), 4)
    assert int(n) == 0


@pytest.mark.parametrize("C, n_real", [(1, 1), (8, 5), (512, 512), (1000, 700)])
def test_lookup_matches_searchsorted(rng, C, n_real):
    """lookup_hilo == numpy searchsorted on the 64-bit keys, exactly:
    hits, misses, duplicates, extremes, and queries equal to the
    SENTINEL pad key (which hit the first pad lane)."""
    from shannon_tpu.ops.spectrum import lookup_hilo

    real = np.sort(
        rng.choice(1 << 40, size=n_real, replace=False).astype(np.uint64)
    )
    table = np.full(C, np.uint64(0xFFFFFFFFFFFFFFFF))
    table[:n_real] = real
    q = np.concatenate([
        rng.choice(real, size=300),
        rng.integers(0, 1 << 40, size=300).astype(np.uint64),
        np.array([0, (1 << 40) - 1, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64),
    ])
    split = lambda x: (  # noqa: E731
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )
    idx, hit = lookup_hilo(*split(table), *split(q))
    pos = np.minimum(np.searchsorted(table, q), C - 1)
    want = table[pos] == q
    np.testing.assert_array_equal(np.asarray(hit), want)
    # a lower bound everywhere, clamped to the last lane
    np.testing.assert_array_equal(np.asarray(idx), pos)


def test_host_read_slice_single_process():
    from shannon_tpu.parallel.multihost import host_read_slice, init_distributed

    assert init_distributed() is False  # no coordinator configured
    s = host_read_slice(1000)
    assert s == slice(0, 1000)


def test_stage_timer(tmp_path):
    from shannon_tpu.utils.timing import StageTimer

    t = StageTimer(out_dir=tmp_path, echo=False)
    with t.stage("alpha", n=3):
        pass
    t.note("alpha", extra=7)
    stats = t.flush_stats(extra={"top": 1})
    assert stats["top"] == 1
    assert stats["stages"]["alpha"]["n"] == 3
    assert stats["stages"]["alpha"]["extra"] == 7
    assert (tmp_path / "timing.log").exists()
    back = json.loads((tmp_path / "stats.json").read_text())
    assert back["stages"]["alpha"]["wall_s"] >= 0


def test_cli_profile_flag_smoke(rng, tmp_path):
    from shannon_tpu.cli import main
    from shannon_tpu.io.fastx import write_fasta
    from shannon_tpu.sim import sample_reads, simulate_transcripts

    ts = simulate_transcripts(rng, n=1, length=260)
    reads = sample_reads(rng, ts, coverage=15, read_length=60)
    f = tmp_path / "r.fasta"
    write_fasta(f, [(f"r{i}", s) for i, s in enumerate(reads)])
    out = tmp_path / "out"
    rc = main([
        "-o", str(out), "--single", str(f), "-K", "21",
        "--kmer-capacity", str(1 << 14), "--backend", "oracle",
        "--profile",
    ])
    assert rc == 0
    assert (out / "profile").exists()
