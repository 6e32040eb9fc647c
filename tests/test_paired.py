"""Paired-end capability tests (BASELINE config 2; SURVEY.md §6 'long
context' = insert-size bridging)."""

import numpy as np
import pytest

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.pipeline import assemble, normalize_mate2
from shannon_tpu.sim import sample_paired_reads, simulate_transcripts
from shannon_tpu.sim import random_seq


def test_normalize_mate2():
    reads = ["ACGT", "AACC", "GGGG", "TTAA"]
    out = normalize_mate2(reads)
    assert out == ["ACGT", "GGTT", "GGGG", "TTAA"]


def test_paired_assembly_simple(rng):
    t = simulate_transcripts(rng, n=2, length=400)
    reads = sample_paired_reads(rng, t, coverage=40, read_length=70,
                                insert_size=200)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    for backend in ("oracle", "device"):
        res = assemble(reads, cfg, backend=backend, paired=True)
        expect = {min(x, revcomp_str(x)) for x in t}
        assert expect <= res.canonical_set(), backend


def test_pair_bridging_resolves_long_repeat(rng):
    # repeat LONGER than the read (so no single read spans it) but
    # shorter than the insert: only mate-pair joining can separate
    # A-R-B from C-R-D.
    a, b, c, d = simulate_transcripts(rng, n=4, length=300)
    r = random_seq(rng, 120)  # read_length 80 < 120 < insert 260
    t1, t2 = a + r + b, c + r + d
    reads = sample_paired_reads(
        rng, [t1, t2], coverage=50, read_length=80, insert_size=260
    )
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    res = assemble(reads, cfg, backend="oracle", paired=True)
    expect = {min(x, revcomp_str(x)) for x in (t1, t2)}
    got = res.canonical_set()
    assert expect <= got
    # chimeras (A-R-D / C-R-B) must NOT be produced
    ch1 = a + r + d
    ch2 = c + r + b
    assert min(ch1, revcomp_str(ch1)) not in got
    assert min(ch2, revcomp_str(ch2)) not in got


def test_paired_backend_parity(rng):
    t = simulate_transcripts(rng, n=2, length=350)
    reads = sample_paired_reads(rng, t, coverage=30, read_length=70,
                                insert_size=220)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    dev = assemble(reads, cfg, backend="device", paired=True)
    orc = assemble(reads, cfg, backend="oracle", paired=True)
    assert [x.seq for x in dev.transcripts] == [x.seq for x in orc.transcripts]


def test_unpaired_flag_ignores_joining(rng):
    t = simulate_transcripts(rng, n=1, length=300)
    reads = sample_paired_reads(rng, t, coverage=30, read_length=70,
                                insert_size=200)
    cfg = AssemblyConfig(k=21, use_pairs=False, kmer_capacity=1 << 15)
    res = assemble(reads, cfg, backend="oracle", paired=True)
    assert {min(x, revcomp_str(x)) for x in t} <= res.canonical_set()


def _toy_graph(klens, edges, k=5):
    """Hand-built ContigGraph: contig i has klen klens[i] (seq length
    klen + k - 1); edges = [(u, v), ...]."""
    from shannon_tpu.oracle.graph import Contig, ContigGraph

    contigs = [
        Contig(kmers=[], seq="A" * (kl + k - 1), abundance=10.0)
        for kl in klens
    ]
    n = len(klens)
    out = [[] for _ in range(n)]
    inc = [[] for _ in range(n)]
    for u, v in edges:
        out[u].append(v)
        inc[v].append(u)
    return ContigGraph(
        k=k, contigs=contigs, out_edges=out, in_edges=inc,
        rc_pair=list(range(n)),
    )


def test_join_rejects_geometrically_impossible_direct_edge():
    """A direct-edge join whose implied fragment blows past the insert
    cap must be refused (SURVEY.md §3.1 'with insert-size constraints')."""
    from shannon_tpu.oracle.multibridge import InsertStats, Run, join_pair_runs

    g = _toy_graph([1000, 300], [(0, 1)])
    cfg = AssemblyConfig(k=5)
    stats = InsertStats(300.0, 25.0)
    # mate 1's run ends only 10 k-mers into the 1000-k-mer contig ->
    # implied fragment ~ 1060 >> 300 + 4*25
    rl = Run(path=[0], p0=0, p1=30, o0=0, o1=10)
    rr = Run(path=[1], p0=2, p1=40, o0=5, o1=43)
    assert join_pair_runs(rl, rr, 70, g, cfg, stats) is None
    # same topology, geometry consistent with the insert -> join
    rl_ok = Run(path=[0], p0=30, p1=60, o0=880, o1=910)
    assert join_pair_runs(rl_ok, rr, 70, g, cfg, stats) == [0, 1]
    # without stats the legacy direct-edge rule joins unconditionally
    assert join_pair_runs(rl, rr, 70, g, cfg, None) == [0, 1]


def test_join_bridges_multi_node_gap():
    """No direct edge: the insert licenses a gap join through
    intermediate contigs (the 'long context' bridge)."""
    from shannon_tpu.oracle.multibridge import InsertStats, Run, join_pair_runs

    # 0 -> 1 -> 2 -> 3 chain, joining run in 0 with run in 3
    g = _toy_graph([200, 60, 60, 200], [(0, 1), (1, 2), (2, 3)])
    cfg = AssemblyConfig(k=5)
    rl = Run(path=[0], p0=10, p1=45, o0=140, o1=175)
    rr = Run(path=[3], p0=0, p1=40, o0=4, o1=44)
    # implied fragment via (1, 2): (200-175) + 120 + 4 + 45 - 0 + 70 = 264
    stats = InsertStats(270.0, 20.0)
    assert join_pair_runs(rl, rr, 70, g, cfg, stats) == [0, 1, 2, 3]
    # without stats, multi-node gaps are never asserted
    assert join_pair_runs(rl, rr, 70, g, cfg, None) is None
    # an insert that cannot reach across the gap -> no join
    assert join_pair_runs(rl, rr, 70, g, cfg, InsertStats(120.0, 10.0)) is None


def test_join_ambiguous_equal_gaps_refused():
    """Two distinct gap paths with identical implied fragments are
    ambiguous evidence -> no join."""
    from shannon_tpu.oracle.multibridge import InsertStats, Run, join_pair_runs

    # 0 -> {1, 2} -> 3, intermediates of EQUAL length
    g = _toy_graph([200, 60, 60, 200], [(0, 1), (0, 2), (1, 3), (2, 3)])
    cfg = AssemblyConfig(k=5)
    rl = Run(path=[0], p0=10, p1=45, o0=140, o1=175)
    rr = Run(path=[3], p0=0, p1=40, o0=4, o1=44)
    stats = InsertStats(220.0, 30.0)
    assert join_pair_runs(rl, rr, 70, g, cfg, stats) is None
    # unequal intermediates: geometry disambiguates -> unique join
    g2 = _toy_graph([200, 60, 100, 200], [(0, 1), (0, 2), (1, 3), (2, 3)])
    # via 1: (200-175) + 60 + 4 + 45 + 70 = 204; via 2: 244
    assert join_pair_runs(rl, rr, 70, g2, cfg, stats) == [0, 1, 3]


def test_insert_stats_estimated_from_same_contig_pairs():
    from shannon_tpu.oracle.multibridge import (
        Run,
        estimate_insert_stats,
    )

    g = _toy_graph([500], [])
    cfg = AssemblyConfig(k=5)
    pairs = []
    for s in (0, 10, 20, 30, 40, 50, 60, 70):
        # fragment 250: mate1 window [s, s+46], mate2 anchors at s+180
        rl = Run(path=[0], p0=0, p1=46, o0=s, o1=s + 46)
        rr = Run(path=[0], p0=0, p1=46, o0=s + 180, o1=s + 226)
        pairs.append((rl, rr, 70, 1))
    st = estimate_insert_stats(pairs, g, cfg)
    # frag = (o2 - o1) + p1 - p2 + r2 = 134 + 46 + 70 = 250
    assert st is not None and st.mean == 250.0
    # configured insert overrides estimation
    cfg2 = AssemblyConfig(k=5, insert_size=300)
    st2 = estimate_insert_stats([], g, cfg2)
    assert st2.mean == 300.0 and st2.sigma == 30.0


def test_two_node_gap_join_resolves_double_repeat(rng):
    """End-to-end known answer: a repeat of TWO
    contigs, each longer than the read, bridged only by mate pairs
    whose gap spans both — requires the insert-licensed 2-intermediate
    gap join; chimeras must not appear."""
    from shannon_tpu.io.dna import revcomp_str

    a, b, c, d, f, gseq = simulate_transcripts(rng, n=6, length=300)
    r1, r2 = random_seq(rng, 125 + 20), random_seq(rng, 125 + 20)
    # T3 = f + r2 + g keeps r1/r2 from condensing (branch into r2)
    t1, t2, t3 = a + r1 + r2 + b, c + r1 + r2 + d, f + r2 + gseq
    insert, rl_ = 460, 70

    reads: list[str] = []
    # coverage: self-pairs (mate2 = RC(mate1)) tile every transcript —
    # they join trivially onto themselves and add no cross-repeat link
    for t in (t1, t2, t3):
        starts = list(range(0, len(t) - rl_ + 1, 17))
        if starts[-1] != len(t) - rl_:
            starts.append(len(t) - rl_)
        for s in starts:
            seg = t[s : s + rl_]
            reads.extend([seg, revcomp_str(seg)])
    # bridge pairs: mate1 fully in the left flank, mate2 fully in the
    # right flank — the gap spans r1+r2 (290bp > any read)
    for t in (t1, t2, t3):
        for s in range(150, 231, 16):
            frag = t[s : s + insert]
            reads.extend([frag[:rl_], revcomp_str(frag[-rl_:])])

    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 16, insert_size=insert,
                         insert_size_std=15.0)
    res = assemble(reads, cfg, backend="oracle", paired=True)
    got = res.canonical_set()
    expect = {min(x, revcomp_str(x)) for x in (t1, t2, t3)}
    assert expect <= got
    for ch in (a + r1 + r2 + d, c + r1 + r2 + b):
        assert min(ch, revcomp_str(ch)) not in got
