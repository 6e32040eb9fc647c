"""Device read-threading parity vs oracle (runs + rescue semantics)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import encode_seq
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum
from shannon_tpu.ops.thread import paths_to_lists, thread_reads_device
from shannon_tpu.oracle.correction import correct_kmers
from shannon_tpu.oracle.counting import count_kmers
from shannon_tpu.oracle.graph import build_contigs
from shannon_tpu.oracle.multibridge import expand_paths, thread_reads
from shannon_tpu.sim import random_seq, sample_reads, simulate_isoforms, simulate_transcripts


def _both_graphs(reads, cfg, cap=1 << 16):
    b = pack_reads(reads, pad_length=max(len(s) for s in reads))
    canonical = not cfg.strand_specific
    spec = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), cfg.k, cap, canonical
    )
    assert not spec.overflowed()
    spec = correct_spectrum(
        spec, cfg.k, cfg.min_abundance, cfg.sibling_ratio,
        cfg.correction_rounds, canonical, error_rate=cfg.error_rate,
    )
    ca = build_contig_arrays(spec, cfg.k, canonical)
    dev_graph = to_contig_graph(ca, cfg.k, cfg)
    alive = correct_kmers(count_kmers(reads, cfg.k, cfg.strand_specific), cfg)
    orc_graph = build_contigs(alive, cfg)
    return b, ca, dev_graph, orc_graph


def _dev_evidence(b, ca, dev_graph, cfg):
    outs = thread_reads_device(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), ca, cfg.k
    )
    raw = paths_to_lists(*outs, rescue=cfg.rescue_reads)
    return expand_paths(
        raw, dev_graph, cfg, read_lengths=[int(x) for x in b.lengths]
    )[0]


def _as_seq_paths(paths, graph):
    return [tuple(graph.contigs[c].seq for c in p) for p in paths]


@pytest.mark.parametrize("error_rate", [0.0, 0.02])
@pytest.mark.parametrize("rescue", [True, False])
def test_threading_parity(rng, error_rate, rescue):
    ts = simulate_transcripts(rng, n=2, length=250) + simulate_isoforms(
        rng, exon_length=120
    )
    reads = sample_reads(
        rng, ts, coverage=20, read_length=70, error_rate=error_rate
    )
    cfg = AssemblyConfig(k=21, rescue_reads=rescue)
    b, ca, dev_graph, orc_graph = _both_graphs(reads, cfg)
    dev_paths = _dev_evidence(b, ca, dev_graph, cfg)
    orc_paths = thread_reads([encode_seq(s) for s in reads], orc_graph, cfg)[0]
    assert _as_seq_paths(dev_paths, dev_graph) == _as_seq_paths(
        orc_paths, orc_graph
    )


def test_threading_150bp_parity(rng):
    """150bp reads (the dominant modern Illumina shape) push the window
    count past 127, exercising the widened packed compaction key;
    parity vs oracle must hold."""
    ts = simulate_transcripts(rng, n=2, length=500) + simulate_isoforms(
        rng, exon_length=220
    )
    reads = sample_reads(
        rng, ts, coverage=20, read_length=150, error_rate=0.01
    )
    cfg = AssemblyConfig(k=21)
    b, ca, dev_graph, orc_graph = _both_graphs(reads, cfg)
    assert b.pad_length - cfg.k + 1 > 127  # the widened-key regime
    dev_paths = _dev_evidence(b, ca, dev_graph, cfg)
    orc_paths = thread_reads([encode_seq(s) for s in reads], orc_graph, cfg)[0]
    assert _as_seq_paths(dev_paths, dev_graph) == _as_seq_paths(
        orc_paths, orc_graph
    )


def test_rescue_multiplies_evidence(rng):
    # with errors, rescue keeps fragments of error-broken reads
    ts = simulate_transcripts(rng, n=2, length=250)
    reads = sample_reads(rng, ts, coverage=20, read_length=70, error_rate=0.03)
    cfg_r = AssemblyConfig(k=21, rescue_reads=True)
    cfg_n = AssemblyConfig(k=21, rescue_reads=False)
    b, ca, dev_graph, _ = _both_graphs(reads, cfg_r)
    n_rescued = len(_dev_evidence(b, ca, dev_graph, cfg_r))
    n_longest = len(_dev_evidence(b, ca, dev_graph, cfg_n))
    assert n_rescued > n_longest


def test_threading_repeat_crossing(rng):
    # reads spanning a repeat: multi-contig paths must be ordered right
    a, b_, c, d = simulate_transcripts(rng, n=4, length=150)
    r = random_seq(rng, 40)
    ts = [a + r + b_, c + r + d]
    reads = sample_reads(rng, ts, coverage=25, read_length=80)
    cfg = AssemblyConfig(k=21)
    b, ca, dev_graph, orc_graph = _both_graphs(reads, cfg)
    dev_paths = _dev_evidence(b, ca, dev_graph, cfg)
    orc_paths = thread_reads([encode_seq(s) for s in reads], orc_graph, cfg)[0]
    assert _as_seq_paths(dev_paths, dev_graph) == _as_seq_paths(
        orc_paths, orc_graph
    )
    assert max(len(p) for p in dev_paths) >= 3  # some read spans a->r->b


def test_threading_no_hits(rng):
    ts = simulate_transcripts(rng, n=1, length=200)
    reads = sample_reads(rng, ts, coverage=10, read_length=60)
    cfg = AssemblyConfig(k=21)
    b, ca, dev_graph, orc_graph = _both_graphs(reads, cfg)
    alien = pack_reads([random_seq(np.random.default_rng(1), 60)] * 4, 60)
    outs = thread_reads_device(
        jnp.asarray(alien.codes), jnp.asarray(alien.lengths), ca, cfg.k
    )
    assert paths_to_lists(*outs) == [[], [], [], []]


@pytest.mark.parametrize("rescue", [True, False])
@pytest.mark.parametrize("strand_specific", [False, True])
def test_runs_to_flat_paths_matches_list_path(rng, rescue, strand_specific):
    """The vectorized single-end evidence builder must emit exactly the
    per-run paths + RC twins the list path (paths_to_lists +
    expand_paths) emits, in the same order."""
    from shannon_tpu.ops.thread import (
        compact_thread_outputs,
        evidence_grid,
        pack_evidence,
        runs_to_flat_paths,
        unpack_evidence,
    )

    cfg = AssemblyConfig(rescue_reads=rescue, strand_specific=strand_specific)
    ts = simulate_transcripts(rng, n=3, length=300) + simulate_isoforms(
        rng, exon_length=120
    )
    reads = sample_reads(rng, ts, coverage=6.0, read_length=60,
                         error_rate=0.02)
    b, ca, dev_graph, _ = _both_graphs(reads, cfg)
    outs = thread_reads_device(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), ca, cfg.k
    )
    # list path
    raw = paths_to_lists(*outs, rescue=cfg.rescue_reads)
    want_paths, want_w = expand_paths(
        raw, dev_graph, cfg, read_lengths=[int(x) for x in b.lengths]
    )
    # vectorized path through the compacted transfer (the production
    # driver's route: across-read compaction -> measured-size pack ->
    # host rectangular rebuild)
    comp = compact_thread_outputs(*outs)
    c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_runs, totals = comp
    tot_e, tot_r = (int(x) for x in np.asarray(totals))
    cap_e = min(evidence_grid(tot_e, minimum=4), int(c_cid.shape[0]))
    cap_e += cap_e % 2
    cap_r = min(evidence_grid(tot_r, minimum=4), int(c_p0.shape[0]))
    buf = pack_evidence(
        c_cid, c_run, c_p0, c_p1, c_o0, c_o1, outs[2], n_runs,
        jnp.asarray(b.lengths), cap_e, cap_r,
    )
    d = unpack_evidence(np.asarray(buf), cap_e, cap_r, b.n_reads)
    np.testing.assert_array_equal(
        d["lengths"], np.asarray(b.lengths, np.int32)
    )
    # rectangular rebuild must equal the kernel's own (trimmed) outputs
    w = d["ev_cid"].shape[1]
    np.testing.assert_array_equal(d["ev_cid"], np.asarray(outs[0])[:, :w])
    rc = None if strand_specific else np.asarray(dev_graph.rc_pair, np.int64)
    flat, offs, weights = runs_to_flat_paths(
        d["ev_cid"], d["ev_run"], d["n_events"], d["run_p0"], d["run_p1"],
        rc, rescue=cfg.rescue_reads,
    )
    got_paths = [
        flat[offs[i] : offs[i + 1]].tolist() for i in range(len(offs) - 1)
    ]
    assert got_paths == want_paths
    assert weights.tolist() == want_w
