"""Oracle error correction — the reference's abundance filter + iterative
extension correction (SURVEY.md §3.1 extension_correction, §4.2).

Spec (binding for the device pipeline):

  1. **Abundance filter**: drop k-mers with count < min_abundance
     (0 = auto — choose_min_abundance), then, when min_abundance > 1,
     **dead-end rescue** (dead_end_rescue below): iteratively revive
     dropped k-mers that extend an alive dead end, so transcript ends
     and interior coverage dips — whose counts are boundary-limited,
     not expression-limited — survive the cut while error chains
     (forked off interiors whose true continuation is alive) stay
     dead.

  2. **Sibling-ratio branch pruning**, iterated to fixpoint (or
     correction_rounds):  work on the *canonical orientation* of each
     alive k-mer x (its packed value; for strand-specific input, the
     as-counted orientation).  Define
       right-siblings(x) = alive k-mers of the form prefix_{k-1}(x)·b,
       left-siblings(x)  = alive k-mers of the form b·suffix_{k-1}(x),
     where membership is tested up to canonicalization.  x is pruned in a
     round if
       count(x) < sibling_ratio * max(count over right-siblings(x)) OR
       count(x) < sibling_ratio * max(count over left-siblings(x)),
     with the comparison evaluated in IEEE float32 (the device compute
     precision — fixing the precision makes oracle/device parity exact at
     threshold boundaries).
     (x is its own sibling on both sides, so a lone branch never prunes.)
     All prunes within a round are decided against the round's *starting*
     alive set (jacobi-style, not gauss-seidel) — this makes the result
     order-independent and therefore reproducible on device.

     Rationale: sequencing errors create low-abundance alternative branches
     at dBG forks; the relative threshold removes them while keeping
     legitimate low-expression isoforms whose branches are not dominated.
     This is the role the reference's weak-extension trimming plays
     (exact reference algorithm unverifiable — SURVEY.md §0; this spec is
     the project's contract).

  3. **Tip clipping** (`clip_tips`), iterated with condensation: branch
     pruning removes the fork k-mer of a sequencing-error path but leaves
     the rest dangling (its interior k-mers are their own only siblings).
     On the condensed graph, such remnants are short dead-end or isolated
     contigs.  Per round, remove simultaneously every contig c with
     klen(c) <= tip_klen_effective that is
       * isolated (no in- and no out-edges) and shorter than
         min_transcript_length, or
       * dead on one side, and dominated at its attachment junction:
         abundance(c) < sibling_ratio * max(abundance of competing
         contigs entering the same neighbors), or
       * a **popped bubble**: indeg == outdeg == 1 with in-neighbor u
         and out-neighbor w, dominated by a parallel branch:
         abundance(c) < sibling_ratio * max(abundance of x != c with
         u -> x -> w).  (A sequencing error mid-read creates a parallel
         path reconnecting at both ends — invisible to tip rules.)
     All comparisons in float32.  Re-condense and repeat until fixpoint
     or correction_rounds.
"""

from __future__ import annotations

import numpy as np

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.oracle.counting import canon_kmer, revcomp_kmer


HIST_MAX_COUNT = 1024
"""Histogram bin ceiling for the auto-abundance chooser (counts above
clamp into the top bin — the ladder below never needs finer depth)."""


def histogram_from_counts(counts: dict[int, int]) -> np.ndarray:
    """[HIST_MAX_COUNT + 1] histogram of k-mer counts (oracle twin of
    ops.correction.count_histogram — identical clamping so both
    backends resolve the identical auto threshold)."""
    vals = np.fromiter(counts.values(), np.int64, len(counts))
    return np.bincount(
        np.clip(vals, 0, HIST_MAX_COUNT), minlength=HIST_MAX_COUNT + 1
    )


def choose_min_abundance(hist: np.ndarray) -> int:
    """Coverage-aware auto abundance threshold (VERDICT r4 item 1) from
    the k-mer count histogram.  Deterministic, backend-independent.

    Sequencing errors put most of their k-mers in the count-1/2 band
    (each error mints up to k novel k-mers, nearly all unique), so at
    deep coverage the raw table is dominated by error k-mers the
    pipeline later deletes anyway — but only after paying k-mer-scale
    correction + condensation for them (~25s of the 82s 1M-read e2e in
    round 4).  The classic k-mer-spectrum valley cut does not transfer
    to transcriptomes: log-normal expression smears the coverage peak
    into a plateau with NO valley (measured on the pinned 20x dataset —
    histogram monotone decreasing to c=28), and a valley-level cut
    costs real recall of low-expression isoforms.  Recall-first rule
    instead:

      * gate: the error band must dominate the table —
        h[1] >= 0.3 * distinct entries (error-free data never cuts);
      * depth: m = instance-weighted median count (the count of the
        median sequenced k-mer INSTANCE; errors carry few instances
        each, so m tracks the k-coverage of the median-expression
        transcript — mean-normalized lognormal(0,1) expression puts it
        at ~1.65x the mean k-coverage);
      * ladder: t=2 iff m >= 64, t=3 iff m >= 256, t=4 iff m >= 1024,
        else 1.  A true k-mer with count < t then belongs to a
        transcript expressed >= ~32x below the instance median — the
        regime where recovery is marginal at any threshold.  Measured
        on the 500-transcript 1M-read bench sim (133x mean coverage,
        m~140 -> t=2): the cut removes 8.26M of 10.7M distinct k-mers
        while touching 0.24% of true k-mers; the 33x/250k and 20x
        pinned-quality sims fall below the gate (m~42 / ~25) and stay
        uncut, keeping QUALITY.md recall bit-identical.
    """
    h = np.asarray(hist, np.float64)
    if len(h) < 3:
        return 1
    c = np.arange(len(h), dtype=np.float64)
    inst = h * c
    total_inst = inst.sum()
    distinct = h.sum()
    if total_inst <= 0 or distinct <= 0:
        return 1
    if h[1] < 0.3 * distinct:
        return 1  # no dominant error band: never cut clean data
    m = int(np.searchsorted(np.cumsum(inst), total_inst / 2.0))
    if m >= 1024:
        return 4
    if m >= 256:
        return 3
    if m >= 64:
        return 2
    return 1


def resolve_min_abundance(config, counts: dict[int, int] | None = None,
                          hist: np.ndarray | None = None) -> int:
    """config.min_abundance, with 0 = auto resolved from the histogram
    (either a counts dict or a precomputed histogram)."""
    if config.min_abundance != 0:
        return config.min_abundance
    if hist is None:
        hist = histogram_from_counts(counts)
    return choose_min_abundance(hist)


def error_cap(comp, error_rate: float):
    """Absolute error-model cap (binding for both backends, float32):
    the largest branch count consistent with SEQUENCING ERROR against
    competing flow `comp` — lam + 4*sqrt(lam) + 1 with
    lam = error_rate/3 * comp (the expected count of one specific
    substitution branch), floored at 3.  A ratio-dominated branch is
    pruned only when its count is ALSO <= this cap: relative domination
    alone deletes every minor isoform below sibling_ratio of its
    sibling's expression regardless of coverage depth, while real error
    branches sit within a few sigma of lam at every scale (round-5
    splicing-gate finding; see AssemblyConfig.error_rate).
    error_rate <= 0 disables (returns +inf).  Accepts scalars or
    arrays; all arithmetic float32 so device/oracle decisions agree
    bit-for-bit at threshold boundaries."""
    if error_rate <= 0:
        return np.float32(np.inf)
    eps3 = np.float32(error_rate) / np.float32(3.0)
    lam = eps3 * np.float32(comp)
    return np.maximum(
        np.float32(3.0),
        lam + np.float32(4.0) * np.sqrt(lam) + np.float32(1.0),
    )


def _alive_count(counts: dict[int, int], v: int, k: int, strand_specific: bool) -> int:
    key = v if strand_specific else canon_kmer(v, k)
    return counts.get(key, 0)


def dead_end_rescue(
    counts: dict[int, int], alive: dict[int, int], config: AssemblyConfig
) -> dict[int, int]:
    """Abundance-filter RESCUE (spec, binding for the device twin in
    ops.correction._correct_fused): after dropping k-mers with
    count < min_abundance, iteratively rescue dropped k-mers that
    extend an alive DEAD END:

      x (dropped) is rescued in a round iff
        (some left-extension of x is alive AND every right-sibling of x
         is dead)   [x extends an alive k-mer that is otherwise dead on
                     its right: x's right-sibling group IS that parent's
                     right-extension set]
      or the left/right mirror.

    Rounds are jacobi (decided against the round's starting alive set)
    and capped at k + 2 — the regrowth depth that matters: transcript
    END fringes are a few k-mers deep (boundary coverage ~cov/L per
    position) and a single error's interior dip spans <= k k-mers,
    while a stretch still sub-threshold after k+2 rounds of regrowth
    belongs to expression ~the cut's ladder floor below the median,
    where recovery is marginal at any threshold.  (The cap is also the
    cost: each round is two [8, C] gathers at the RAW table, and a 3k
    cap spends most of its rounds regrowing doomed deep-sub-threshold
    interiors.)  Rescued k-mers keep their
    true counts.

    Why: transcript END k-mers are covered only by reads starting at
    the boundary, so their counts stay ~Poisson(coverage/read_length)
    no matter how deep the interior coverage is — a blind count cut
    truncates the ends of perfectly recoverable transcripts (measured:
    t=2 at 28x lost a verify-dataset transcript, 1,808 true k-mers at
    the 1M bench point).  Sequencing-error chains hang off interior
    forks whose true continuation is ALIVE, so the all-siblings-dead
    condition never rescues them; the few error chains dangling off
    true transcript ends that do regrow are short dead-end contigs the
    tip clip removes anyway."""
    k = config.k
    ss = config.strand_specific
    mask = (1 << (2 * k)) - 1
    hi_shift = 2 * (k - 1)
    dropped = {v: c for v, c in counts.items() if v not in alive}
    alive = dict(alive)

    def is_alive(v: int) -> bool:
        key = v if ss else canon_kmer(v, k)
        return key in alive

    for _ in range(k + 2):
        newly: list[int] = []
        for v, c in dropped.items():
            lext_any = any(
                is_alive((v >> 2) | (b << hi_shift)) for b in range(4)
            )
            if lext_any:
                rsib_dead = all(
                    not is_alive((v & ~0x3) | b) for b in range(4)
                )
                if rsib_dead:
                    newly.append(v)
                    continue
            rext_any = any(
                is_alive(((v << 2) | b) & mask) for b in range(4)
            )
            if rext_any:
                lsib_dead = all(
                    not is_alive((b << hi_shift) | (v & (mask >> 2)))
                    for b in range(4)
                )
                if lsib_dead:
                    newly.append(v)
        if not newly:
            break
        for v in newly:
            alive[v] = dropped.pop(v)
    return alive


def correct_kmers(
    counts: dict[int, int], config: AssemblyConfig
) -> dict[int, int]:
    """Return the corrected (k-mer -> count) table per the spec above."""
    k = config.k
    ss = config.strand_specific
    min_ab = resolve_min_abundance(config, counts)
    alive = {v: c for v, c in counts.items() if c >= min_ab}
    if min_ab > 1:
        alive = dead_end_rescue(counts, alive, config)
    if config.sibling_ratio <= 0.0:
        return alive

    mask = (1 << (2 * k)) - 1
    hi_shift = 2 * (k - 1)

    for _ in range(config.correction_rounds):
        pruned: list[int] = []
        for v, c in alive.items():
            # right siblings: prefix_{k-1}(v) . b
            base = v & ~0x3
            rmax = 0
            for b in range(4):
                rmax = max(rmax, _alive_count(alive, base | b, k, ss))
            # left siblings: b . suffix_{k-1}(v)
            suf = (v << 2) & mask
            suf >>= 2  # == v & (mask >> 2), bottom 2(k-1) bits
            lmax = 0
            for b in range(4):
                lmax = max(lmax, _alive_count(alive, (b << hi_shift) | suf, k, ss))
            ratio = np.float32(config.sibling_ratio)
            cf = np.float32(c)
            doom = (
                cf < ratio * np.float32(rmax)
                and cf <= error_cap(np.float32(rmax), config.error_rate)
            ) or (
                cf < ratio * np.float32(lmax)
                and cf <= error_cap(np.float32(lmax), config.error_rate)
            )
            if doom:
                pruned.append(v)
        if not pruned:
            break
        for v in pruned:
            del alive[v]
    return alive


def clip_tips(alive: dict[int, int], config: AssemblyConfig) -> dict[int, int]:
    """Iterated condensed-graph tip clipping per the spec (step 3)."""
    from shannon_tpu.oracle.counting import canon_kmer
    from shannon_tpu.oracle.graph import build_contigs

    tip_klen = config.tip_klen_effective
    if tip_klen < 0:
        return alive
    err_klen = config.error_klen_effective
    err_ratio = np.float32(config.error_branch_ratio)

    def dom_ratio(n_kmers: int) -> np.float32:
        # k-mer-scale branches (one substitution error's footprint) are
        # held to the stricter error_branch_ratio; longer branches (real
        # isoform structure) keep the lax sibling_ratio
        if config.error_branch_ratio > 0.0 and n_kmers <= err_klen:
            return err_ratio
        return np.float32(config.sibling_ratio)

    alive = dict(alive)
    for _ in range(config.correction_rounds):
        g = build_contigs(alive, config)
        doomed: list[int] = []
        for cid, c in enumerate(g.contigs):
            if len(c.kmers) > tip_klen:
                continue
            has_in = len(g.in_edges[cid]) > 0
            has_out = len(g.out_edges[cid]) > 0
            if not has_in and not has_out:
                if len(c.seq) < config.min_transcript_length:
                    doomed.append(cid)
                continue
            if has_in and has_out:
                # bubble rule: parallel branch u -> c -> w dominated by a
                # sibling branch u -> x -> w.  The strict
                # error_branch_ratio applies only against competitors of
                # ERROR-comparable length: a substitution's parallel
                # bubble and its true twin both span ~k k-mers between
                # the same junctions, while an exon-skip junction (the
                # same <= k-1 k-mer footprint!) competes against the
                # whole skipped exon — hundreds of k-mers.  Holding the
                # skip branch to the strict ratio deleted minor isoforms
                # at < 0.5x the major's abundance (measured: the
                # two-isoform known-answer loses the 0.3-abundance skip
                # with ZERO errors); competitor-length classing keeps
                # the r3 error-flood fix without that collateral.
                if len(g.in_edges[cid]) == 1 and len(g.out_edges[cid]) == 1:
                    u = g.in_edges[cid][0]
                    w = g.out_edges[cid][0]
                    comp_lax = 0.0
                    comp_strict = 0.0
                    for x in g.out_edges[u]:
                        if x != cid and x in g.in_edges[w]:
                            comp_lax = max(comp_lax, g.contigs[x].abundance)
                            if len(g.contigs[x].kmers) <= err_klen:
                                comp_strict = max(
                                    comp_strict, g.contigs[x].abundance
                                )
                    ab = np.float32(c.abundance)
                    lax = np.float32(config.sibling_ratio)
                    er = config.error_rate
                    doom = ab < lax * np.float32(comp_lax) and ab <= error_cap(
                        np.float32(comp_lax), er
                    )
                    if (
                        config.error_branch_ratio > 0.0
                        and len(c.kmers) <= err_klen
                    ):
                        doom = doom or (
                            ab < err_ratio * np.float32(comp_strict)
                            and ab <= error_cap(np.float32(comp_strict), er)
                        )
                    if doom:
                        doomed.append(cid)
                continue
            # dead on exactly one side: find competitors at the junction
            comp = 0.0
            if not has_in:  # attached on the right
                for d in g.out_edges[cid]:
                    for e in g.in_edges[d]:
                        if e != cid:
                            comp = max(comp, g.contigs[e].abundance)
            else:  # attached on the left
                for d in g.in_edges[cid]:
                    for e in g.out_edges[d]:
                        if e != cid:
                            comp = max(comp, g.contigs[e].abundance)
            # float32 comparison — device compute precision (parity);
            # error-cap conjunction as everywhere (error_cap rationale)
            if np.float32(c.abundance) < dom_ratio(
                len(c.kmers)
            ) * np.float32(comp) and np.float32(c.abundance) <= error_cap(
                np.float32(comp), config.error_rate
            ):
                doomed.append(cid)
        if not doomed:
            break
        for cid in doomed:
            for v in g.contigs[cid].kmers:
                key = v if config.strand_specific else canon_kmer(v, config.k)
                alive.pop(key, None)
    return alive
