"""Native C++ ingest: parity with the Python parser + speed sanity."""

import time

import numpy as np
import pytest

from shannon_tpu.io.fastx import write_fasta
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.native import load, pack_file
from shannon_tpu.sim import random_seq


@pytest.fixture(scope="module")
def lib():
    return load()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A plain file never falls back to Python when the C++ build
    fails: the failure reaches the caller with the compiler's message."""
    import shannon_tpu.native as nat

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_SRC", bad)
    monkeypatch.setattr(nat, "_SO", tmp_path / "build" / "x.so")
    p = tmp_path / "r.fasta"
    write_fasta(p, [("r0", "ACGT")])
    with pytest.raises(RuntimeError, match="native ingest"):
        pack_file(p)
    assert not list((tmp_path / "build").glob("*"))  # no partial object


def _py_batch(path, pad):
    from shannon_tpu.io.fastx import read_fastx

    return pack_reads([s for _, s in read_fastx(path)], pad)


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.lengths, b.lengths)


def test_native_fasta_parity(rng, tmp_path, lib):
    seqs = [random_seq(rng, int(n)) for n in rng.integers(10, 150, size=50)]
    seqs[3] = seqs[3][:5] + "NnXx" + seqs[3][5:]  # invalid chars
    p = tmp_path / "r.fasta"
    write_fasta(p, [(f"r{i} desc", s) for i, s in enumerate(seqs)], width=37)
    _assert_batches_equal(pack_file(p, 128), _py_batch(p, 128))


def test_native_fastq_parity(rng, tmp_path, lib):
    seqs = [random_seq(rng, 100) for _ in range(40)]
    p = tmp_path / "r.fastq"
    with open(p, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    _assert_batches_equal(pack_file(p, 128), _py_batch(p, 128))


def test_native_truncation(rng, tmp_path, lib):
    p = tmp_path / "r.fasta"
    write_fasta(p, [("long", random_seq(rng, 300))])
    b = pack_file(p, 64)
    assert b.lengths.tolist() == [64]
    _assert_batches_equal(b, _py_batch(p, 64))


def test_native_gzip_falls_back(rng, tmp_path):
    import gzip

    p = tmp_path / "r.fa.gz"
    with gzip.open(p, "wt") as fh:
        fh.write(">a\nACGTACGT\n")
    b = pack_file(p, 16)
    assert b.sequences() == ["ACGTACGT"]


def test_native_missing_file(tmp_path):
    with pytest.raises(Exception):
        pack_file(tmp_path / "nope.fasta", 64)


def test_native_speedup(rng, tmp_path, lib):
    seqs = [random_seq(rng, 100) for _ in range(20000)]
    p = tmp_path / "big.fastq"
    with open(p, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    t0 = time.perf_counter()
    nb = pack_file(p, 128)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = _py_batch(p, 128)
    t_python = time.perf_counter() - t0
    _assert_batches_equal(nb, pb)
    assert t_native < t_python, (t_native, t_python)


def _write_fastq(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i} x\n{s}\n+\n{'I' * len(s)}\n")


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("n_ranges", [1, 2, 3, 7])
def test_byte_range_ingest_partitions_exactly(rng, tmp_path, fmt, n_ranges):
    """Any byte partition of the file must yield every record exactly
    once, in order, identical to the full parse (both the native path
    and the Python reader)."""
    from shannon_tpu.native import _py_range_records, pack_file_range

    seqs = [random_seq(rng, int(n)) for n in rng.integers(20, 120, size=61)]
    p = tmp_path / f"r.{fmt}"
    if fmt == "fasta":
        write_fasta(p, [(f"r{i} d", s) for i, s in enumerate(seqs)], width=41)
    else:
        _write_fastq(p, seqs)
    size = p.stat().st_size
    full = pack_file(p, 128)

    def run_ranges(pack_range):
        cuts = sorted(
            {0, size, *(int(x) for x in rng.integers(1, size, size=n_ranges - 1))}
        )
        parts = [
            pack_range(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])
        ]
        codes = np.vstack([b.codes for b in parts if b.n_reads])
        lengths = np.concatenate([b.lengths for b in parts if b.n_reads])
        np.testing.assert_array_equal(codes, full.codes)
        np.testing.assert_array_equal(lengths, full.lengths)
        # bytes actually read scale ~1/N per range by construction

    run_ranges(lambda lo, hi: pack_file_range(p, lo, hi, 128))
    # the Python reader keeps the same contract
    run_ranges(
        lambda lo, hi: pack_reads(_py_range_records(p, lo, hi), 128)
    )


def test_byte_range_splits_mid_record(rng, tmp_path):
    """Cut points landing inside a record's lines must assign the whole
    record to the range owning its header byte."""
    from shannon_tpu.native import pack_file_range

    seqs = [random_seq(rng, 80) for _ in range(5)]
    p = tmp_path / "r.fastq"
    _write_fastq(p, seqs)
    size = p.stat().st_size
    full = pack_file(p, 128)
    # try every byte as the single cut point (small file, exhaustive)
    for cut in range(0, size + 1, 7):
        a = pack_file_range(p, 0, cut, 128)
        b = pack_file_range(p, cut, size, 128)
        assert a.n_reads + b.n_reads == full.n_reads, cut
        got = np.vstack([x.codes for x in (a, b) if x.n_reads])
        np.testing.assert_array_equal(got, full.codes)


def test_byte_range_rejects_gzip(tmp_path):
    from shannon_tpu.native import pack_file_range

    import gzip

    p = tmp_path / "r.fasta.gz"
    with gzip.open(p, "wt") as fh:
        fh.write(">r0\nACGT\n")
    with pytest.raises(ValueError):
        pack_file_range(p, 0, 10, 16)


def test_host_byte_range_partitions_file(tmp_path, monkeypatch):
    from shannon_tpu.parallel import multihost

    p = tmp_path / "x.bin"
    p.write_bytes(b"z" * 1000)

    class FakeJax:
        @staticmethod
        def process_index():
            return FakeJax._p

        @staticmethod
        def process_count():
            return 4

    import sys

    ranges = []
    real_jax = sys.modules["jax"]
    for i in range(4):
        FakeJax._p = i
        monkeypatch.setattr(real_jax, "process_index", FakeJax.process_index)
        monkeypatch.setattr(real_jax, "process_count", FakeJax.process_count)
        ranges.append(multihost.host_byte_range(p))
    assert ranges[0][0] == 0 and ranges[-1][1] == 1000
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0


def test_pack_file_records_fasta_fastq(rng, tmp_path, lib):
    """Record-indexed parse (pair-aligned multi-host primitive): every
    (skip, count) window equals the full parse's slice, FASTA and
    FASTQ."""
    from shannon_tpu.native import pack_file_records

    seqs = [random_seq(rng, int(n)) for n in rng.integers(20, 90, size=23)]
    fa = tmp_path / "r.fasta"
    write_fasta(fa, [(f"r{i}", s) for i, s in enumerate(seqs)], width=31)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    for path in (fa, fq):
        full = pack_file(path, 96)
        for skip, count in ((0, 5), (3, 7), (20, 3), (0, 23), (23, 0)):
            part = pack_file_records(path, skip, count, 96)
            assert part.n_reads == count
            np.testing.assert_array_equal(
                part.codes, full.codes[skip : skip + count]
            )
            np.testing.assert_array_equal(
                part.lengths, full.lengths[skip : skip + count]
            )


def test_paired_range_ingest_matches_full(rng, tmp_path, lib):
    """Pair-aligned range ingest: concatenating every host's range
    batch reproduces the full paired ingest exactly (single-process
    simulation of H hosts via monkeypatched byte ranges)."""
    import shannon_tpu.parallel.multihost as mh
    from shannon_tpu.pipeline import (
        ingest_paired_files,
        ingest_paired_files_range,
    )

    n = 17
    left = [random_seq(rng, 60) for _ in range(n)]
    right = [random_seq(rng, 60) for _ in range(n)]
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(left)])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(right)])
    full = ingest_paired_files(str(lf), str(rf), pad_length=64)

    size = lf.stat().st_size
    H = 3
    orig = mh.host_byte_range
    parts = []
    try:
        for h in range(H):
            mh.host_byte_range = (
                lambda p, h=h: (h * size // H, (h + 1) * size // H)
            )
            parts.append(
                ingest_paired_files_range(str(lf), str(rf), pad_length=64)
            )
    finally:
        mh.host_byte_range = orig
    assert all(p.n_reads % 2 == 0 for p in parts)  # whole pairs per host
    got_words = np.vstack([p.words for p in parts if p.n_reads])
    np.testing.assert_array_equal(got_words, full.words)
    np.testing.assert_array_equal(
        np.concatenate([p.lengths for p in parts]), full.lengths
    )
