"""Device correction parity vs oracle correct_kmers (SURVEY.md §5.1)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.correction import abundance_filter, correct_spectrum
from shannon_tpu.ops.count import count_spectrum
from shannon_tpu.ops.spectrum import lookup_counts, neighbor_counts
from shannon_tpu.ops.kmers import hilo_to_int
from shannon_tpu.oracle.correction import correct_kmers
from shannon_tpu.oracle.counting import canon_kmer, count_kmers, str_to_kmer
from shannon_tpu.sim import random_seq, sample_reads, simulate_transcripts


def _spec_of(reads, k, cap=1 << 13, canonical=True):
    b = pack_reads(reads, pad_length=max(len(s) for s in reads))
    return count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), k, cap, canonical
    )


def test_lookup_counts(rng):
    reads = [random_seq(rng, 60) for _ in range(20)]
    k = 15
    spec = _spec_of(reads, k)
    oracle = count_kmers(reads, k)
    keys = sorted(oracle)
    qhi = jnp.array([kk >> 32 for kk in keys], dtype=jnp.uint32)
    qlo = jnp.array([kk & 0xFFFFFFFF for kk in keys], dtype=jnp.uint32)
    got = lookup_counts(spec, qhi, qlo)
    assert got.tolist() == [oracle[kk] for kk in keys]
    # absent keys -> 0
    miss = lookup_counts(
        spec,
        jnp.array([0, 123456], dtype=jnp.uint32),
        jnp.array([9999, 42], dtype=jnp.uint32),
    )
    absent = [(0 << 32) | 9999, (123456 << 32) | 42]
    expect = [oracle.get(a, 0) for a in absent]
    assert miss.tolist() == expect


@pytest.mark.parametrize("k", [13, 17, 24])
def test_neighbor_counts_match_oracle(rng, k):
    ts = simulate_transcripts(rng, n=2, length=200)
    reads = sample_reads(rng, ts, coverage=10, read_length=60, error_rate=0.02)
    spec = _spec_of(reads, k)
    oracle = count_kmers(reads, k)
    r_ext, l_ext, r_sib, l_sib = neighbor_counts(spec, k)
    n = int(spec.n)
    keys = hilo_to_int(spec.hi[:n], spec.lo[:n])
    mask = (1 << (2 * k)) - 1
    hs = 2 * (k - 1)
    for i in rng.choice(n, size=min(50, n), replace=False):
        v = int(keys[i])
        for b in range(4):
            r = canon_kmer(((v << 2) | b) & mask, k)
            assert int(r_ext[b, i]) == oracle.get(r, 0), (i, b, "rext")
            l = canon_kmer((v >> 2) | (b << hs), k)
            assert int(l_ext[b, i]) == oracle.get(l, 0), (i, b, "lext")
        rs = max(oracle.get(canon_kmer((v & ~3) | b, k), 0) for b in range(4))
        ls = max(
            oracle.get(canon_kmer((b << hs) | (v & (mask >> 2)), k), 0)
            for b in range(4)
        )
        assert int(r_sib[i]) == rs
        assert int(l_sib[i]) == ls


def test_abundance_filter_parity(rng):
    reads = [random_seq(rng, 50) for _ in range(40)] * 2
    k = 13
    spec = abundance_filter(_spec_of(reads, k), 2)
    oracle = {v: c for v, c in count_kmers(reads, k).items() if c >= 2}
    assert spec.to_dict() == oracle


@pytest.mark.parametrize("k", [15, 24])
@pytest.mark.parametrize("canonical", [True, False])
def test_correct_spectrum_parity(rng, k, canonical):
    ts = simulate_transcripts(rng, n=3, length=250)
    reads = sample_reads(
        rng, ts, coverage=25, read_length=70, error_rate=0.01,
        both_strands=canonical,
    )
    cfg = AssemblyConfig(
        k=k, sibling_ratio=0.1, min_abundance=1, strand_specific=not canonical
    )
    spec = _spec_of(reads, k, canonical=canonical)
    got = correct_spectrum(
        spec, k, cfg.min_abundance, cfg.sibling_ratio, cfg.correction_rounds,
        canonical, error_rate=cfg.error_rate,
    )
    oracle = correct_kmers(
        count_kmers(reads, k, strand_specific=not canonical), cfg
    )
    assert got.to_dict() == oracle


# ---- auto min_abundance ----------------------------------------------


def test_choose_min_abundance_ladder():
    from shannon_tpu.oracle.correction import (
        HIST_MAX_COUNT,
        choose_min_abundance,
    )

    def hist(pairs):
        h = np.zeros(HIST_MAX_COUNT + 1, np.int64)
        for c, n in pairs:
            h[min(c, HIST_MAX_COUNT)] += n
        return h

    # deep coverage + dominant error band -> cut at 2
    h = hist([(1, 8_000_000), (2, 1_200_000), (150, 700_000)])
    assert choose_min_abundance(h) == 2
    # very deep coverage -> 3, then 4
    assert choose_min_abundance(hist([(1, 8_000_000), (400, 700_000)])) == 3
    assert choose_min_abundance(hist([(1, 8_000_000), (1024, 700_000)])) == 4
    # shallow coverage (median instance count < 64) -> never cut
    assert choose_min_abundance(hist([(1, 3_000_000), (25, 700_000)])) == 1
    # error-free deep coverage (no dominant singleton band) -> never cut
    assert choose_min_abundance(hist([(1, 1_000), (200, 700_000)])) == 1
    # degenerate histograms
    assert choose_min_abundance(np.zeros(1025, np.int64)) == 1
    assert choose_min_abundance(np.zeros(2, np.int64)) == 1


def test_count_histogram_matches_oracle(rng):
    from shannon_tpu.oracle.correction import (
        HIST_MAX_COUNT,
        histogram_from_counts,
    )
    from shannon_tpu.ops.correction import count_histogram

    reads = [random_seq(rng, 50) for _ in range(30)]
    reads += reads[:10]  # duplicate some so counts > 1 exist
    k = 15
    spec = _spec_of(reads, k)
    got = np.asarray(count_histogram(spec, HIST_MAX_COUNT))
    want = histogram_from_counts(count_kmers(reads, k))
    np.testing.assert_array_equal(got, want)


def test_auto_min_abundance_device_oracle_parity(rng):
    """Deep-coverage + errors dataset where the auto chooser engages:
    device and oracle must resolve the SAME threshold and produce the
    identical corrected table."""
    from shannon_tpu.oracle.correction import (
        histogram_from_counts,
        choose_min_abundance,
    )
    from shannon_tpu.ops.correction import count_histogram
    from shannon_tpu.pipeline import assemble

    ts = simulate_transcripts(rng, n=3, length=300)
    reads = sample_reads(
        rng, ts, coverage=150.0, read_length=60, error_rate=0.02
    )
    k = 21
    counts = count_kmers(reads, k)
    t_oracle = choose_min_abundance(histogram_from_counts(counts))
    assert t_oracle >= 2  # the gate must engage at this depth
    spec = _spec_of(reads, k, cap=1 << 15)
    t_device = choose_min_abundance(np.asarray(count_histogram(spec, 1024)))
    assert t_device == t_oracle

    cfg = AssemblyConfig(
        k=k, kmer_capacity=1 << 15, min_abundance=0,
        min_transcript_length=100, min_output_abundance=0.0,
    )
    dev = assemble(reads, cfg, backend="device")
    orc = assemble(reads, cfg, backend="oracle")
    assert dev.canonical_set() == orc.canonical_set()


def test_dead_end_rescue_keeps_ends_kills_error_chains(rng):
    """Known-answer for the rescue spec: a deep-coverage transcript with
    a singleton END k-mer keeps its full length under min_abundance=2
    (the end chain is rescued), while a singleton error branch forked
    off the interior is NOT rescued (its fork parent still has an alive
    true continuation)."""
    from shannon_tpu.oracle.correction import correct_kmers
    from shannon_tpu.oracle.counting import canon_kmer, count_kmers, str_to_kmer

    k = 15
    t = random_seq(rng, 120)
    # interior coverage 10x, but the transcript END appears only once:
    reads = [t[i : i + 40] for i in range(0, 70, 4) for _ in range(10)]
    reads += [t[-40:]]  # single read covering the end
    # an error read: one substitution mid-read, appearing once
    err = t[30:70]
    err = err[:20] + ("A" if err[20] != "A" else "C") + err[21:]
    reads += [err]
    cfg = AssemblyConfig(k=k, min_abundance=2, sibling_ratio=0.0)
    alive = correct_kmers(count_kmers(reads, k), cfg)
    tail_kmer = canon_kmer(str_to_kmer(t[-k:]), k)
    err_kmer = canon_kmer(str_to_kmer(err[20 - k // 2 : 20 - k // 2 + k]), k)
    assert tail_kmer in alive, "end chain was not rescued"
    assert err_kmer not in alive, "error branch was rescued"
    # every k-mer of the true transcript survives (full end regrowth)
    for i in range(len(t) - k + 1):
        assert canon_kmer(str_to_kmer(t[i : i + k]), k) in alive
