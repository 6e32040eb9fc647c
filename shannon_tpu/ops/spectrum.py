"""Sorted-spectrum probes: vectorized two-word binary search.

The corrected spectrum is the device's replacement for the reference's
k-mer dict (SURVEY.md §4.2 'python dict' hot loop #2): membership and
count lookups become log2(capacity) gather+compare steps over the sorted
(hi, lo) table, batched across every query lane at once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from shannon_tpu.ops.count import Spectrum
from shannon_tpu.ops.kmers import SENTINEL, canonical_hilo


def _lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def lookup_hilo(
    thi: jnp.ndarray,
    tlo: jnp.ndarray,
    qhi: jnp.ndarray,
    qlo: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized lower_bound of (qhi, qlo) in the sorted two-word table
    (thi, tlo): log2(C) gather+compare passes over every query lane at
    once.  Returns (index clamped to C-1, exact-hit mask).  SENTINEL
    pads are the maximum key, so probing them is safe.

    The one lookup kernel: on the H100 it beats a sort-merge join of
    table and queries at both pipeline shapes (PERF.md, PR 1)."""
    C = thi.shape[0]
    n_iter = max(C.bit_length(), 1)
    lo_idx = jnp.zeros(qhi.shape, dtype=jnp.int32)
    width = jnp.full(qhi.shape, C, dtype=jnp.int32)

    def body(_, state):
        lo_idx, width = state
        half = width // 2
        mid = lo_idx + half
        mh = thi[jnp.minimum(mid, C - 1)]
        ml = tlo[jnp.minimum(mid, C - 1)]
        go_right = _lt(mh, ml, qhi, qlo)
        lo_idx = jnp.where(go_right, mid + 1, lo_idx)
        width = jnp.where(go_right, width - half - 1, half)
        return lo_idx, width

    lo_idx, _ = jax.lax.fori_loop(0, n_iter, body, (lo_idx, width))
    lo_idx = jnp.minimum(lo_idx, C - 1)
    hit = (thi[lo_idx] == qhi) & (tlo[lo_idx] == qlo)
    return lo_idx, hit


@jax.jit
def lookup_counts(
    spec: Spectrum, qhi: jnp.ndarray, qlo: jnp.ndarray
) -> jnp.ndarray:
    """Count of each query k-mer (0 if absent).  Queries must already be
    in table orientation (canonical for canonical spectra).  Any shape."""
    shape = qhi.shape
    qhi, qlo = qhi.reshape(-1), qlo.reshape(-1)
    idx, hit = lookup_hilo(spec.hi, spec.lo, qhi, qlo)
    return jnp.where(hit, spec.count[idx], 0).reshape(shape)


@partial(jax.jit, static_argnames=("k", "canonical"))
def sibling_maxes(
    spec: Spectrum, k: int, canonical: bool = True
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Max counts of each entry's right-sibling group (prefix_{k-1}(x)·b)
    and left-sibling group (b·suffix_{k-1}(x)) — the two outputs the
    correction rounds actually consume.  Half the probe volume of
    neighbor_counts (8 probes, not 16): the probe lookup is the round's
    dominant cost at pipeline scale, so the unused extension probes were
    pure waste (VERDICT r2 item 1b)."""
    hi, lo = spec.hi, spec.lo
    hi_mask = jnp.uint32((1 << (2 * k - 32)) - 1 if 2 * k > 32 else 0)
    lo_mask = jnp.uint32(0xFFFFFFFF if 2 * k >= 32 else (1 << (2 * k)) - 1)
    hs = 2 * (k - 1)
    probes_h, probes_l = [], []
    for b in range(4):
        bb = jnp.uint32(b)
        # right sibling: prefix·b = (v & ~3) | b
        probes_h.append(hi)
        probes_l.append((lo & ~jnp.uint32(3)) | bb)
        # left sibling: b·suffix = (b << 2(k-1)) | (v & (mask >> 2))
        sh = hi & (hi_mask >> 2) if 2 * k > 32 else hi
        sl = lo if 2 * k > 32 else lo & (lo_mask >> 2)
        if hs >= 32:
            lsh = sh | (bb << (hs - 32))
            lsl = sl
        else:
            lsh = sh
            lsl = sl | (bb << hs)
        probes_h.append(lsh)
        probes_l.append(lsl)
    ph = jnp.stack(probes_h, axis=0)  # [8, C]: (rsib, lsib) x 4
    pl = jnp.stack(probes_l, axis=0)
    if canonical:
        ph, pl = canonical_hilo(ph, pl, k)
    counts = lookup_counts(spec, ph, pl)  # [8, C]
    right_sib_max = jnp.max(counts[0::2], axis=0)
    left_sib_max = jnp.max(counts[1::2], axis=0)
    pad = (hi == SENTINEL) & (lo == SENTINEL)
    z = jnp.int32(0)
    return (
        jnp.where(pad, z, right_sib_max),
        jnp.where(pad, z, left_sib_max),
    )


@partial(jax.jit, static_argnames=("k", "canonical"))
def neighbor_counts(
    spec: Spectrum, k: int, canonical: bool = True
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """For every table entry x, the counts of its 4 right-extensions
    (suffix_{k-1}(x)·b) and 4 left-extensions (b·prefix_{k-1}(x)),
    plus the max counts of its right-sibling group (prefix_{k-1}(x)·b)
    and left-sibling group (b·suffix_{k-1}(x)).

    Returns (right_ext [4,C], left_ext [4,C], right_sib_max [C],
    left_sib_max [C]) — base axis first.  SENTINEL lanes return
    zeros.
    """
    hi, lo = spec.hi, spec.lo
    hi_mask = jnp.uint32((1 << (2 * k - 32)) - 1 if 2 * k > 32 else 0)
    lo_mask = jnp.uint32(0xFFFFFFFF if 2 * k >= 32 else (1 << (2 * k)) - 1)
    hs = 2 * (k - 1)  # top-base shift

    # Build all 16 probe keys, canonicalize, and resolve them through a
    # SINGLE batched binary search (one 16x-wide query beats 16 searches
    # for both compile size and device utilization).
    probes_h, probes_l = [], []
    for b in range(4):
        bb = jnp.uint32(b)
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
        # right sibling: prefix·b = (v & ~3) | b
        probes_h.append(hi)
        probes_l.append((lo & ~jnp.uint32(3)) | bb)
        # left sibling: b·suffix = (b << 2(k-1)) | (v & (mask >> 2))
        sh = hi & (hi_mask >> 2) if 2 * k > 32 else hi
        sl = lo if 2 * k > 32 else lo & (lo_mask >> 2)
        if hs >= 32:
            lsh = sh | (bb << (hs - 32))
            lsl = sl
        else:
            lsh = sh
            lsl = sl | (bb << hs)
        probes_h.append(lsh)
        probes_l.append(lsl)
    ph = jnp.stack(probes_h, axis=0)  # [16, C]: (rext, lext, rsib, lsib) x 4
    pl = jnp.stack(probes_l, axis=0)
    if canonical:
        ph, pl = canonical_hilo(ph, pl, k)
    counts = lookup_counts(spec, ph, pl)  # [16, C]
    right_ext = counts[0::4]
    left_ext = counts[1::4]
    right_sib_max = jnp.max(counts[2::4], axis=0)
    left_sib_max = jnp.max(counts[3::4], axis=0)
    pad = (hi == SENTINEL) & (lo == SENTINEL)
    z = jnp.int32(0)
    return (
        jnp.where(pad[None, :], z, right_ext),
        jnp.where(pad[None, :], z, left_ext),
        jnp.where(pad, z, right_sib_max),
        jnp.where(pad, z, left_sib_max),
    )
