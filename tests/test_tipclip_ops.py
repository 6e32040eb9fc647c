"""Device tip-clipping parity vs oracle clip_tips (SURVEY.md §5.1)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum
from shannon_tpu.ops.tipclip import clip_tips_spectrum
from shannon_tpu.oracle.correction import clip_tips, correct_kmers, error_cap
from shannon_tpu.oracle.counting import count_kmers
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts


def _device_alive(reads, cfg, cap=1 << 16):
    canonical = not cfg.strand_specific
    b = pack_reads(reads, pad_length=max(len(s) for s in reads))
    spec = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), cfg.k, cap, canonical
    )
    assert not spec.overflowed(), "test capacity too small"
    spec = correct_spectrum(
        spec, cfg.k, cfg.min_abundance, cfg.sibling_ratio,
        cfg.correction_rounds, canonical, error_rate=cfg.error_rate,
    )
    spec = clip_tips_spectrum(spec, cfg, canonical)
    return spec.to_dict()


def _oracle_alive(reads, cfg):
    alive = correct_kmers(count_kmers(reads, cfg.k, cfg.strand_specific), cfg)
    return clip_tips(alive, cfg)


@pytest.mark.parametrize("error_rate", [0.0, 0.01, 0.03])
def test_tipclip_parity(rng, error_rate):
    ts = simulate_transcripts(rng, n=2, length=280) + simulate_isoforms(
        rng, exon_length=130
    )
    reads = sample_reads(
        rng, ts, abundances=[1, 4, 2, 1], coverage=30, read_length=70,
        error_rate=error_rate,
    )
    cfg = AssemblyConfig(k=21)
    assert _device_alive(reads, cfg) == _oracle_alive(reads, cfg)


def test_tipclip_removes_error_debris(rng):
    t = simulate_transcripts(rng, n=1, length=300)[0]
    reads = sample_reads(rng, [t], coverage=50, read_length=70, error_rate=0.02)
    cfg = AssemblyConfig(k=21)
    got = _device_alive(reads, cfg)
    true_kmers = set(count_kmers([t], cfg.k))
    assert true_kmers <= set(got)
    # correction + tip clipping removes the bulk of the ~6k raw error
    # k-mers; survivors are bubble-shaped error paths (reconnect at both
    # ends), which tip rules cannot see — bubble popping is a separate
    # stage (future); require >85% debris removal here
    raw = set(count_kmers(reads, cfg.k))
    assert len(set(got) - true_kmers) < 0.15 * len(raw - true_kmers)


def test_tipclip_strand_specific_parity(rng):
    ts = simulate_transcripts(rng, n=2, length=220)
    reads = sample_reads(
        rng, ts, coverage=25, read_length=60, error_rate=0.01, both_strands=False
    )
    cfg = AssemblyConfig(k=19, strand_specific=True)
    assert _device_alive(reads, cfg) == _oracle_alive(reads, cfg)


def test_tipclip_disabled(rng):
    ts = simulate_transcripts(rng, n=1, length=200)
    reads = sample_reads(rng, ts, coverage=20, read_length=60, error_rate=0.01)
    cfg = AssemblyConfig(k=19, tip_klen=-1)
    dev = _device_alive(reads, cfg)
    orc = _oracle_alive(reads, cfg)
    assert dev == orc  # both no-ops beyond correction


def _graph_fingerprint(ca, k, cfg):
    """Numbering-independent structural fingerprint of a contig graph:
    multiset of (seq, abundance, sorted successor seqs, rc twin seq)."""
    from shannon_tpu.ops.condense import to_contig_graph

    g = to_contig_graph(ca, k, cfg)
    seqs = [c.seq for c in g.contigs]
    return sorted(
        (
            seqs[i],
            round(g.contigs[i].abundance, 5),
            tuple(sorted(seqs[j] for j in g.out_edges[i])),
            seqs[g.rc_pair[i]],
        )
        for i in range(len(seqs))
    )


@pytest.mark.parametrize("error_rate", [0.01, 0.03])
def test_clip_remap_matches_recondensation(rng, error_rate):
    """Condense once: the ContigArrays that
    clip_tips_graph assembles from the host clip state must be
    structurally identical to a fresh device condensation of the
    clipped spectrum — same contigs, abundances, edges, rc pairing,
    and same node-level (kmer -> contig, offset) mapping."""
    from shannon_tpu.ops.condense import build_contig_arrays
    from shannon_tpu.ops.count import shrink_spectrum
    from shannon_tpu.ops.tipclip import clip_tips_graph

    ts = simulate_transcripts(rng, n=3, length=400) + simulate_isoforms(
        rng, exon_length=150
    )
    reads = sample_reads(
        rng, ts, abundances=[1, 3, 2, 4, 1], coverage=25, read_length=70,
        error_rate=error_rate,
    )
    cfg = AssemblyConfig(k=21)
    b = pack_reads(reads, pad_length=70)
    spec = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), cfg.k, 1 << 16
    )
    spec = correct_spectrum(
        spec, cfg.k, cfg.min_abundance, cfg.sibling_ratio,
        cfg.correction_rounds, True,
    )
    spec2, ca_remap = clip_tips_graph(spec, cfg, canonical=True)
    assert ca_remap is not None, "expected the fast remap path"
    ca_ref = build_contig_arrays(shrink_spectrum(spec2), cfg.k, True)
    assert _graph_fingerprint(ca_remap, cfg.k, cfg) == _graph_fingerprint(
        ca_ref, cfg.k, cfg
    )
    # node-level equality: same sorted (hi, lo) table, and each entry
    # maps into the same contig CONTENT at the same offset
    n_keep = int(ca_remap.n_nodes)
    assert n_keep == int(ca_ref.n_nodes)
    for fld in ("node_hi", "node_lo", "node_count", "node_off"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ca_remap, fld)[:n_keep]),
            np.asarray(getattr(ca_ref, fld)[:n_keep]),
            err_msg=fld,
        )
    from shannon_tpu.ops.condense import contig_sequences

    seq_remap = contig_sequences(ca_remap, cfg.k)
    seq_ref = contig_sequences(ca_ref, cfg.k)
    cid_map_remap = np.asarray(ca_remap.node_cid[:n_keep])
    cid_map_ref = np.asarray(ca_ref.node_cid[:n_keep])
    assert [seq_remap[c] for c in cid_map_remap] == [
        seq_ref[c] for c in cid_map_ref
    ]


def test_clip_remap_skipped_when_nothing_doomed(rng):
    """Error-free input dooms nothing: clip_tips_graph must return the
    pre-clip ContigArrays unchanged (no remap program minted)."""
    from shannon_tpu.ops.tipclip import clip_tips_graph

    ts = simulate_transcripts(rng, n=2, length=250)
    reads = sample_reads(rng, ts, coverage=20, read_length=60, error_rate=0.0)
    cfg = AssemblyConfig(k=19)
    b = pack_reads(reads, pad_length=64)
    spec = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), cfg.k, 1 << 14
    )
    spec = correct_spectrum(
        spec, cfg.k, cfg.min_abundance, cfg.sibling_ratio,
        cfg.correction_rounds, True,
    )
    spec2, ca = clip_tips_graph(spec, cfg, canonical=True)
    assert ca is not None
    assert spec2.to_dict() == spec.to_dict()


def test_doom_round1_matches_scalar_reference(rng):
    """The vectorized round-1 doom scan must reproduce the per-contig
    scalar decision exactly on random graphs (isolated / dead-end /
    bubble classes, float32 semantics, self-loops)."""
    from shannon_tpu.ops.tipclip import _doom_round1

    cfg = AssemblyConfig(k=21)
    tip_klen = cfg.tip_klen_effective
    err_klen = cfg.error_klen_effective
    for trial in range(25):
        n = int(rng.integers(3, 120))
        klen = rng.integers(1, 2 * tip_klen, n).astype(np.int64)
        csum = (klen * rng.integers(1, 30, n)).astype(np.int64)
        out_adj = [
            sorted(
                set(rng.integers(0, n, rng.integers(0, 4)).tolist())
            )[:4]
            for _ in range(n)
        ]
        inc_adj = [[] for _ in range(n)]
        for u, a in enumerate(out_adj):
            for v in a:
                inc_adj[v].append(u)
        abv = np.float32(csum) / np.float32(klen)
        if cfg.error_branch_ratio > 0.0:
            rv = np.where(
                klen <= err_klen,
                np.float32(cfg.error_branch_ratio),
                np.float32(cfg.sibling_ratio),
            ).astype(np.float32)
        else:
            rv = np.full(n, np.float32(cfg.sibling_ratio), np.float32)

        def scalar_doom(c):  # the original _doom_check round-1 logic
            if klen[c] > tip_klen:
                return False
            inc_c, out_c = inc_adj[c], out_adj[c]
            if not inc_c and not out_c:
                return klen[c] + cfg.k - 1 < cfg.min_transcript_length
            comp = np.float32(0.0)
            if inc_c and out_c:
                if len(inc_c) == 1 and len(out_c) == 1:
                    # round-5 bubble rule: strict ratio only vs
                    # error-comparable-length competitors (exon-skip vs
                    # substitution distinction)
                    u, w = inc_c[0], out_c[0]
                    comp_s = np.float32(0.0)
                    for x in out_adj[u]:
                        if x != c and x in inc_adj[w]:
                            if abv[x] > comp:
                                comp = abv[x]
                            if klen[x] <= err_klen and abv[x] > comp_s:
                                comp_s = abv[x]
                    if abv[c] < np.float32(
                        cfg.sibling_ratio
                    ) * comp and abv[c] <= error_cap(comp, cfg.error_rate):
                        return True
                    return (
                        cfg.error_branch_ratio > 0.0
                        and klen[c] <= err_klen
                        and abv[c]
                        < np.float32(cfg.error_branch_ratio) * comp_s
                        and abv[c] <= error_cap(comp_s, cfg.error_rate)
                    )
                return False
            if not inc_c:
                for d in out_c:
                    for e in inc_adj[d]:
                        if e != c and abv[e] > comp:
                            comp = abv[e]
            else:
                for d in inc_c:
                    for e in out_adj[d]:
                        if e != c and abv[e] > comp:
                            comp = abv[e]
            return abv[c] < rv[c] * comp and abv[c] <= error_cap(
                comp, cfg.error_rate
            )

        expect = [c for c in range(n) if scalar_doom(c)]
        got = _doom_round1(klen, csum, out_adj, cfg).tolist()
        assert got == expect, f"trial {trial}: {got} != {expect}"


def test_error_branch_ratio_pops_low_coverage_bubble(rng):
    """A single-substitution bubble at coverage 4 survives the lax
    sibling_ratio (1 >= 0.1*4) but is popped by error_branch_ratio
    (1 < 0.5*4); a long low branch (real isoform structure) at the same
    abundance ratio is protected by the k+2 length gate."""
    t = simulate_transcripts(rng, n=1, length=400)[0]
    # error-free reads at ~4x, plus ONE read with a mid-read error
    reads = sample_reads(rng, [t], coverage=4, read_length=80,
                         error_rate=0.0)
    bad = t[100:180]
    bad = bad[:40] + ("A" if bad[40] != "A" else "C") + bad[41:]
    reads.append(bad)
    cfg = AssemblyConfig(k=21)
    true_kmers = set(count_kmers([t], cfg.k))
    got = set(_device_alive(reads, cfg))
    assert got == true_kmers  # error bubble fully popped
    assert got == set(_oracle_alive(reads, cfg))  # parity
    # with the stricter rule disabled the bubble survives
    cfg_off = AssemblyConfig(k=21, error_branch_ratio=0.0)
    assert set(_device_alive(reads, cfg_off)) > true_kmers


def test_error_branch_ratio_spares_long_isoform_branch(rng):
    """Two isoforms at 8:1 abundance sharing flanking exons: the rare
    isoform's alternative exon is a LONG parallel branch — the k+2
    length gate must keep error_branch_ratio away from it even though
    its abundance ratio (1/8 < 0.5) would doom a short branch."""
    iso = simulate_isoforms(rng, exon_length=120)
    reads = sample_reads(rng, iso, abundances=[8, 1], coverage=8,
                         read_length=70, error_rate=0.0)
    cfg = AssemblyConfig(k=21)
    got = set(_device_alive(reads, cfg))
    for t in iso:
        assert set(count_kmers([t], cfg.k)) <= got
    assert got == set(_oracle_alive(reads, cfg))
