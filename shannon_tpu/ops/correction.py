"""Device error correction: abundance filter + iterated sibling-ratio
branch pruning over the sorted spectrum (reference stage 2's per-k-mer
dict probes — SURVEY.md §4.2 hot loop #2 — as batched binary-search
probes; oracle spec in shannon_tpu/oracle/correction.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.ops.count import Spectrum
from shannon_tpu.ops.kmers import SENTINEL
from shannon_tpu.ops.spectrum import sibling_maxes


@jax.jit
def _compact(spec: Spectrum, keep: jnp.ndarray) -> Spectrum:
    """Drop entries where keep is False; table stays sorted (dropped
    lanes become SENTINEL and sort to the back)."""
    hi = jnp.where(keep, spec.hi, SENTINEL)
    lo = jnp.where(keep, spec.lo, SENTINEL)
    cnt = jnp.where(keep, spec.count, 0)
    hi, lo, cnt = jax.lax.sort((hi, lo, cnt), num_keys=2)
    real = ~((hi == SENTINEL) & (lo == SENTINEL))
    return Spectrum(hi=hi, lo=lo, count=cnt, n=real.sum(dtype=jnp.int32))


@partial(jax.jit, static_argnames=("max_count",))
def count_histogram(spec: Spectrum, max_count: int = 64) -> jnp.ndarray:
    """[max_count + 1] int32 histogram of entry counts: h[c] = # real
    entries with count == c (counts > max_count clamp into the top bin;
    h[0] is forced to 0 — pads don't count).  Feeds the auto
    min_abundance chooser (oracle.correction.choose_min_abundance).

    Sort + binary-search boundaries, NOT a scatter-add: a scatter of
    ~12M colliding updates into 1k bins is the degenerate-contention
    case of the hardware's slowest primitive (docs/DESIGN.md), while
    one single-key sort is ~15ms at this scale and the 1k boundary
    searches are trivial."""
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    c = jnp.where(pad, 0, jnp.clip(spec.count, 0, max_count))
    (c_sorted,) = jax.lax.sort((c,), num_keys=1)
    bounds = jnp.searchsorted(
        c_sorted, jnp.arange(max_count + 2, dtype=jnp.int32)
    ).astype(jnp.int32)
    h = bounds[1:] - bounds[:-1]
    return h.at[0].set(0)


@partial(jax.jit, static_argnames=("min_abundance",))
def abundance_filter(spec: Spectrum, min_abundance: int) -> Spectrum:
    """Drop k-mers with count < min_abundance (oracle correction step 1)."""
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    return _compact(spec, (spec.count >= min_abundance) & ~pad)


@partial(jax.jit, static_argnames=("k", "canonical"))
def sibling_prune_round(
    spec: Spectrum, k: int, sibling_ratio: jnp.ndarray, canonical: bool = True
) -> Spectrum:
    """One jacobi round of sibling-ratio branch pruning (oracle step 2):
    prune x iff float32(count(x)) < ratio * float32(max sibling count)
    on either side."""
    r_sib_max, l_sib_max = sibling_maxes(spec, k, canonical)
    c = spec.count.astype(jnp.float32)
    ratio = sibling_ratio.astype(jnp.float32)
    doomed = (c < ratio * r_sib_max.astype(jnp.float32)) | (
        c < ratio * l_sib_max.astype(jnp.float32)
    )
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    return _compact(spec, ~doomed & ~pad)


def probe_keys(spec: Spectrum, k: int, canonical: bool, side: str):
    """The 8 probe keys of every table lane, [8, C] each for hi and lo:
    (rsib, lsib) x 4 for side='sib', or (rext, lext) x 4 for
    side='ext'."""
    from shannon_tpu.ops.kmers import canonical_hilo

    hi, lo = spec.hi, spec.lo
    hi_mask = jnp.uint32((1 << (2 * k - 32)) - 1 if 2 * k > 32 else 0)
    lo_mask = jnp.uint32(0xFFFFFFFF if 2 * k >= 32 else (1 << (2 * k)) - 1)
    hs = 2 * (k - 1)
    probes_h, probes_l = [], []
    for b in range(4):
        bb = jnp.uint32(b)
        if side == "sib":
            # right sibling: prefix·b
            probes_h.append(hi)
            probes_l.append((lo & ~jnp.uint32(3)) | bb)
            # left sibling: b·suffix
            sh = hi & (hi_mask >> 2) if 2 * k > 32 else hi
            sl = lo if 2 * k > 32 else lo & (lo_mask >> 2)
            if hs >= 32:
                probes_h.append(sh | (bb << (hs - 32)))
                probes_l.append(sl)
            else:
                probes_h.append(sh)
                probes_l.append(sl | (bb << hs))
        else:
            # right extension: ((v << 2) | b) masked
            probes_h.append(((hi << 2) | (lo >> 30)) & hi_mask)
            probes_l.append(((lo << 2) | bb) & lo_mask)
            # left extension: (v >> 2) | (b << 2(k-1))
            lh = hi >> 2
            ll = (lo >> 2) | (hi << 30)
            if hs >= 32:
                lh = lh | (bb << (hs - 32))
            else:
                ll = (ll & jnp.uint32((1 << hs) - 1)) | (bb << hs)
            probes_h.append(lh)
            probes_l.append(ll)
    ph = jnp.stack(probes_h, axis=0)
    pl = jnp.stack(probes_l, axis=0)
    if canonical:
        ph, pl = canonical_hilo(ph, pl, k)
    return ph, pl


@partial(jax.jit, static_argnames=("k", "canonical", "side"))
def _probe_resolve(spec: Spectrum, k: int, canonical: bool, side: str):
    """Resolve one 8-probe set (probe_keys) against the table.  One
    lookup per program call, not one 16-probe lookup and not two in one
    program: the lookup's transient memory scales with the query lanes.
    Probe targets never change across correction rounds
    (pruning/rescue only toggles counts), so each set resolves exactly
    once."""
    from shannon_tpu.ops.spectrum import lookup_hilo

    C = spec.capacity
    ph, pl = probe_keys(spec, k, canonical, side)
    i_, h_ = lookup_hilo(spec.hi, spec.lo, ph.reshape(-1), pl.reshape(-1))
    return jnp.clip(i_.reshape(8, C), 0, C - 1), h_.reshape(8, C)


@partial(jax.jit, static_argnames=("min_abundance",))
def _cut_counts(spec: Spectrum, min_abundance: int):
    """(raw counts with pads zeroed, post-abundance-cut counts)."""
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    raw = jnp.where(pad, 0, spec.count)
    return raw, jnp.where(raw < min_abundance, 0, raw)


@partial(jax.jit, static_argnames=("rounds",))
def _rescue(counts, raw, sidx, shit, eidx, ehit, rounds: int):
    """Dead-end rescue to fixpoint, at most `rounds` jacobi rounds, as
    one early-exit while_loop (oracle spec:
    oracle.correction.dead_end_rescue): a dropped k-mer revives iff it
    extends an alive k-mer that is otherwise dead on that side — some
    left-extension alive AND all right-siblings dead (x's right-sibling
    group IS that parent's right-extension set), or the mirror."""

    def cond(st):
        r, _c, changed = st
        return changed & (r < rounds)

    def body(st):
        r, counts, _ = st
        alive8 = (counts > 0).astype(jnp.uint8)  # narrow the gathers
        pa_s = shit & (alive8[sidx] > 0)  # [8, C] aliveness gathers
        pa_e = ehit & (alive8[eidx] > 0)
        rsib_dead = ~jnp.any(pa_s[0::2], axis=0)
        lsib_dead = ~jnp.any(pa_s[1::2], axis=0)
        rext_any = jnp.any(pa_e[0::2], axis=0)
        lext_any = jnp.any(pa_e[1::2], axis=0)
        resc = (
            (raw > 0)
            & (counts == 0)
            & ((lext_any & rsib_dead) | (rext_any & lsib_dead))
        )
        return r + 1, jnp.where(resc, raw, counts), resc.any()

    _, counts, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), counts, jnp.bool_(True))
    )
    return counts


@partial(jax.jit, static_argnames=("rounds", "use_cap"))
def _prune(
    counts, sidx, shit, sibling_ratio, eps3, rounds: int, use_cap: bool
):
    """Jacobi sibling-prune rounds to fixpoint, at most `rounds`, as one
    early-exit while_loop; decision semantics identical to the oracle —
    float32 ratio test AND (when use_cap) the absolute error cap
    (oracle.correction.error_cap, identical float32 arithmetic)."""
    ratio = sibling_ratio.astype(jnp.float32)

    def _cap(F):
        lam = eps3 * F
        return jnp.maximum(
            jnp.float32(3.0),
            lam + jnp.float32(4.0) * jnp.sqrt(lam) + jnp.float32(1.0),
        )

    def cond(st):
        r, _c, changed = st
        return changed & (r < rounds)

    def body(st):
        r, counts, _ = st
        pc = jnp.where(shit, counts[sidx], 0)  # [8, C] gathers
        rmax = jnp.max(pc[0::2], axis=0).astype(jnp.float32)
        lmax = jnp.max(pc[1::2], axis=0).astype(jnp.float32)
        cf = counts.astype(jnp.float32)
        dr = cf < ratio * rmax
        dl = cf < ratio * lmax
        if use_cap:
            dr = dr & (cf <= _cap(rmax))
            dl = dl & (cf <= _cap(lmax))
        doomed = (counts > 0) & (dr | dl)
        return r + 1, jnp.where(doomed, 0, counts), doomed.any()

    _, counts, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), counts, jnp.bool_(True))
    )
    return counts


def correct_spectrum(
    spec: Spectrum,
    k: int,
    min_abundance: int,
    sibling_ratio: float,
    correction_rounds: int,
    canonical: bool = True,
    error_rate: float = 0.0,
) -> Spectrum:
    """Full correction: abundance filter (+ dead-end rescue when the
    filter is engaged) then pruning rounds to fixpoint, with the
    absolute error-model cap on domination prunes.

    Probe sets resolve ONCE (one lookup per program), then rescue and
    prune each run as one while_loop execution that stops at its
    fixpoint.  Decision semantics are identical to the oracle (jacobi
    float32 tests, error cap, k+2 rescue bound) — pinned by the parity
    suite."""
    if sibling_ratio <= 0.0:
        return abundance_filter(spec, min_abundance)
    sidx, shit = _probe_resolve(spec, k, canonical, "sib")
    raw, counts = _cut_counts(spec, min_abundance)
    if min_abundance > 1:  # the rescue runs only behind an abundance cut
        eidx, ehit = _probe_resolve(spec, k, canonical, "ext")
        counts = _rescue(counts, raw, sidx, shit, eidx, ehit, k + 2)
        del eidx, ehit  # free the extension probe tables
    # divided on the host: XLA's float32 division on the GPU is not
    # IEEE round-to-nearest, and the spec's cap is
    eps3 = jnp.float32(np.float32(error_rate) / np.float32(3.0))
    counts = _prune(
        counts, sidx, shit, jnp.float32(sibling_ratio), eps3,
        correction_rounds, error_rate > 0,
    )
    return _compact(spec, counts > 0)
