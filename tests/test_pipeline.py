"""Pipeline + CLI tests: device/oracle backend parity end-to-end,
checkpoint/resume stage-skip contract (SURVEY.md §5.1, §6)."""

import json

import numpy as np
import pytest

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.io.fastx import read_fastx, write_fasta
from shannon_tpu.pipeline import assemble, run_pipeline
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts


@pytest.fixture
def dataset(rng):
    ts = simulate_transcripts(rng, n=2, length=350) + simulate_isoforms(
        rng, exon_length=150
    )
    reads = sample_reads(
        rng, ts, abundances=[1, 3, 4, 1], coverage=30, read_length=70,
        error_rate=0.005,
    )
    return ts, reads


def test_backend_parity(dataset):
    """The golden gate: device spectrum path == oracle path, transcript
    for transcript."""
    ts, reads = dataset
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    dev = assemble(reads, cfg, backend="device")
    orc = assemble(reads, cfg, backend="oracle")
    assert [t.seq for t in dev.transcripts] == [t.seq for t in orc.transcripts]
    assert dev.canonical_set() == orc.canonical_set()
    expect = {min(t, revcomp_str(t)) for t in ts}
    assert expect <= dev.canonical_set()


def test_150bp_auto_pad_end_to_end(rng):
    """Auto read_pad_length (config default 0) sizes the device batch to
    the 160 pad for a 150bp library — no truncation — and the full
    device pipeline matches the oracle."""
    ts = simulate_transcripts(rng, n=3, length=600)
    reads = sample_reads(
        rng, ts, coverage=25, read_length=150, error_rate=0.005
    )
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    assert cfg.read_pad_length == 0  # auto is the default
    dev = assemble(reads, cfg, backend="device")
    orc = assemble(reads, cfg, backend="oracle")
    assert [t.seq for t in dev.transcripts] == [t.seq for t in orc.transcripts]
    expect = {min(t, revcomp_str(t)) for t in ts}
    assert expect <= dev.canonical_set()


def test_run_pipeline_files_and_resume(dataset, tmp_path):
    ts, reads = dataset
    fasta_in = tmp_path / "reads.fasta"
    write_fasta(fasta_in, [(f"r{i}", s) for i, s in enumerate(reads)])
    out = tmp_path / "out"
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15, out_dir=str(out))

    res1 = run_pipeline(cfg, single=str(fasta_in), backend="device")
    assert (out / "transcripts.fasta").exists()
    assert (out / "reads.npz").exists()
    assert (out / "spectrum.npz").exists()
    assert (out / "timing.log").exists()
    stats = json.loads((out / "stats.json").read_text())
    assert "spectrum" in stats["stages"]

    # resume: all stages skipped, same transcripts
    res2 = run_pipeline(cfg, single=str(fasta_in), backend="device")
    assert res2.stats.get("resumed") is True
    assert {t.seq for t in res2.transcripts} == {t.seq for t in res1.transcripts}

    # no-resume recomputes and matches
    cfg3 = AssemblyConfig(
        k=21, kmer_capacity=1 << 15, out_dir=str(out), resume=False
    )
    res3 = run_pipeline(cfg3, single=str(fasta_in), backend="device")
    assert {t.seq for t in res3.transcripts} == {t.seq for t in res1.transcripts}


def test_run_pipeline_paired(rng, tmp_path):
    from shannon_tpu.sim import sample_paired_reads

    t = simulate_transcripts(rng, n=1, length=400)[0]
    reads = sample_paired_reads(rng, [t], coverage=40, read_length=70)
    left = [reads[i] for i in range(0, len(reads), 2)]
    right = [reads[i] for i in range(1, len(reads), 2)]
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(left)])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(right)])
    cfg = AssemblyConfig(
        k=21, kmer_capacity=1 << 15, out_dir=str(tmp_path / "out")
    )
    res = run_pipeline(cfg, left=str(lf), right=str(rf), backend="device")
    assert res.canonical_set() == {min(t, revcomp_str(t))}


def test_paired_ingest_file_vs_memory_batches(rng, tmp_path):
    """The file route (ingest_paired_files) and the in-memory route
    (pack_reads(normalize_mate2(...), paired=True)) must produce
    identical batches — codes, lengths, paired flag (the two mate-2
    normalizations pinned together)."""
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.pipeline import ingest_paired_files, normalize_mate2
    from shannon_tpu.sim import sample_paired_reads

    t = simulate_transcripts(rng, n=2, length=300)
    reads = sample_paired_reads(rng, t, coverage=10, read_length=63)
    left = reads[0::2]
    right = reads[1::2]
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(left)])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(right)])

    file_batch = ingest_paired_files(str(lf), str(rf))
    mem_batch = pack_reads(
        normalize_mate2(reads),
        pad_length=file_batch.pad_length,
        paired=True,
    )
    assert file_batch.paired and mem_batch.paired
    np.testing.assert_array_equal(file_batch.lengths, mem_batch.lengths)
    np.testing.assert_array_equal(file_batch.codes, mem_batch.codes)


def test_cli_end_to_end(dataset, tmp_path, capsys):
    from shannon_tpu.cli import main

    ts, reads = dataset
    fasta_in = tmp_path / "reads.fasta"
    write_fasta(fasta_in, [(f"r{i}", s) for i, s in enumerate(reads)])
    out = tmp_path / "cli_out"
    rc = main([
        "-o", str(out), "--single", str(fasta_in), "-K", "21",
        "--kmer-capacity", str(1 << 15), "--backend", "device",
    ])
    assert rc == 0
    recs = list(read_fastx(out / "transcripts.fasta"))
    assert len(recs) >= 4
    got = {min(s, revcomp_str(s)) for _, s in recs}
    assert {min(t, revcomp_str(t)) for t in ts} <= got


def test_cli_pair_knobs_flow_to_config(tmp_path, monkeypatch):
    """--no-pairs / --insert-size / --insert-size-std reach the config
    (the CLI exposes the config's pairing knobs)."""
    import shannon_tpu.pipeline as pl
    from shannon_tpu.cli import main
    from shannon_tpu.pipeline import AssemblyResult

    seen = {}

    def fake_run_pipeline(config, **kw):
        seen["cfg"] = config
        return AssemblyResult(transcripts=[], stats={})

    monkeypatch.setattr(pl, "run_pipeline", fake_run_pipeline)
    rc = main([
        "-o", str(tmp_path), "--left", "l.fa", "--right", "r.fa",
        "--no-pairs", "--insert-size", "300", "--insert-size-std", "25",
        "--backend", "oracle",
    ])
    assert rc == 0
    cfg = seen["cfg"]
    assert cfg.use_pairs is False
    assert cfg.insert_size == 300
    assert cfg.insert_size_std == 25.0


def test_cli_arg_errors(tmp_path, capsys):
    from shannon_tpu.cli import main

    assert main(["-o", str(tmp_path)]) == 2  # no input
    assert main(["-o", str(tmp_path), "--left", "x.fa"]) == 2  # no right
    assert (
        main(["-o", str(tmp_path), "--single", "a.fa", "--left", "b.fa",
              "--right", "c.fa"]) == 2
    )  # both modes


def test_paired_ingest_routes_identical(rng, tmp_path):
    """The two mate-2 normalization routes — in-memory interleaved
    reads through normalize_mate2 + pack_reads, and left/right files
    through run_pipeline's interleave — must produce identical packed
    batches."""
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.pipeline import normalize_mate2
    from shannon_tpu.sim import sample_paired_reads

    ts = simulate_transcripts(rng, n=2, length=400)
    reads = sample_paired_reads(
        rng, ts, coverage=8, read_length=70, error_rate=0.01
    )
    left = reads[0::2]
    right = reads[1::2]
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(left)])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(right)])
    cfg = AssemblyConfig(
        k=21, kmer_capacity=1 << 15, out_dir=str(tmp_path / "out"),
        read_pad_length=70,
    )
    run_pipeline(cfg, left=str(lf), right=str(rf), backend="device")
    ingested = np.load(tmp_path / "out" / "reads.npz")

    mem = pack_reads(
        normalize_mate2(reads), pad_length=cfg.read_pad_length, paired=True
    )
    # reads checkpoint is packed-resident since round 5 (words, not codes)
    np.testing.assert_array_equal(ingested["words"], mem.words)
    np.testing.assert_array_equal(ingested["lengths"], mem.lengths)
    assert int(ingested["pad_length"]) == mem.pad_length
    assert bool(ingested["paired"]) and mem.paired
