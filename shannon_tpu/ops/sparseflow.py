"""Device batched sparse flow (SURVEY.md §8 M4): thousands of per-node
greedy max-min transport decompositions solved as one vmapped
fixed-iteration kernel, bit-identical to the oracle solver
(shannon_tpu/oracle/sparseflow.py — float32 arithmetic, identical
tie-hash, identical restart-selection key).

Nodes are padded to a fixed (M, N) = (8, 8) margin shape (dBG degrees
are <= 4 per side; MB splits can push higher — larger nodes fall back
to the host solver).  Each node is solved with sf_restarts+1 seeds at
once; restart selection (min pairing count, then min support-bitmask)
happens on host from the returned flow tensors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.oracle.sparseflow import SF_MAXD, _node_flows, fnv1a, solve_node

MAXD = SF_MAXD  # padded margin size per side


def _tie_hash_dev(i, j, seed):
    h = (
        i.astype(jnp.uint32) * jnp.uint32(2654435761)
        ^ j.astype(jnp.uint32) * jnp.uint32(40503)
        ^ seed.astype(jnp.uint32)
    )
    h = (h ^ (h >> 16)) * jnp.uint32(2246822519)
    return h ^ (h >> 13)


@partial(jax.jit, static_argnames=("max_steps",))
def batched_greedy(
    a: jnp.ndarray,  # [B, M] float32 (zero-padded)
    b: jnp.ndarray,  # [B, N] float32
    seeds: jnp.ndarray,  # [B] uint32
    use_hash: jnp.ndarray,  # [B] bool (False -> lexicographic ties)
    max_steps: int = 2 * MAXD,
) -> jnp.ndarray:
    """Flow tensors F [B, M, N] of the greedy max-min decomposition."""
    return _greedy_core(a, b, seeds, use_hash, max_steps)


def _greedy_core(a, b, seeds, use_hash, max_steps: int) -> jnp.ndarray:
    B, M = a.shape
    N = b.shape[1]
    eps = jnp.float32(1e-6) * jnp.maximum(
        jnp.maximum(a.sum(1), b.sum(1)), jnp.float32(1.0)
    )  # [B]
    ii = jax.lax.broadcasted_iota(jnp.int32, (M, N), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (M, N), 1)

    def step(_, state):
        a, b, F = state
        m = jnp.minimum(a[:, :, None], b[:, None, :])  # [B, M, N]
        best = m.max(axis=(1, 2))  # [B]
        active = best > eps
        ties = m >= best[:, None, None]
        # lexicographic pick: first tie in row-major order
        flat_lex = jnp.argmax(ties.reshape(B, -1), axis=1)
        # hash pick: max tie_hash, residual ties -> smallest flat index
        h = _tie_hash_dev(ii[None], jj[None], seeds[:, None, None])
        hm = jnp.where(ties, h, 0).max(axis=(1, 2))
        cand = ties & (h == hm[:, None, None])
        flat_hash = jnp.argmax(cand.reshape(B, -1), axis=1)
        flat = jnp.where(use_hash, flat_hash, flat_lex).astype(jnp.int32)
        pi = flat // N
        pj = flat % N
        oh_i = jax.nn.one_hot(pi, M, dtype=jnp.float32)  # [B, M]
        oh_j = jax.nn.one_hot(pj, N, dtype=jnp.float32)
        f = jnp.where(active, best, 0.0)
        a = a - f[:, None] * oh_i
        b = b - f[:, None] * oh_j
        F = F + f[:, None, None] * (oh_i[:, :, None] * oh_j[:, None, :])
        return a, b, F

    F0 = jnp.zeros((B, M, N), jnp.float32)
    _, _, F = jax.lax.fori_loop(0, max_steps, step, (a, b, F0))
    return F


@partial(jax.jit, static_argnames=("k_restarts", "max_steps"))
def batched_greedy_packed(
    buf: jnp.ndarray,  # [B, 2*MAXD+1] int32: bitcast a | bitcast b | seed
    k_restarts: int,
    max_steps: int = 2 * MAXD,
) -> jnp.ndarray:
    """One-upload / one-download batched solve: expand each job to
    k_restarts+1 seeded greedy runs ON DEVICE, then select the best
    restart ON DEVICE with the oracle's exact key (pairing count, then
    uint64 support bitmask at stride MAXD, then earliest restart).
    Returns the winning flow tensors [B, MAXD, MAXD].

    One transfer each way per solve, in place of four uploads and a
    full-[B*K] download."""
    B = buf.shape[0]
    K = k_restarts + 1
    a1 = jax.lax.bitcast_convert_type(buf[:, :MAXD], jnp.float32)
    b1 = jax.lax.bitcast_convert_type(buf[:, MAXD : 2 * MAXD], jnp.float32)
    node_seed = buf[:, 2 * MAXD].astype(jnp.uint32)
    a = jnp.repeat(a1, K, axis=0)  # [B*K, MAXD]
    b = jnp.repeat(b1, K, axis=0)
    r = jax.lax.broadcasted_iota(jnp.uint32, (B, K), 1).reshape(-1)
    seeds = jnp.where(r > 0, jnp.repeat(node_seed, K) + r, 0)
    use_hash = r > 0
    F = _greedy_core(a, b, seeds, use_hash, max_steps)  # [B*K, M, N]

    # restart selection (oracle _best_of_restarts key, vectorized)
    nz = F > 0
    counts = nz.sum(axis=(1, 2)).reshape(B, K)
    cell = (
        jax.lax.broadcasted_iota(jnp.uint32, (MAXD, MAXD), 0) * MAXD
        + jax.lax.broadcasted_iota(jnp.uint32, (MAXD, MAXD), 1)
    )
    one = jnp.uint32(1)
    lo_bit = jnp.where(cell < 32, one << cell, 0)
    hi_bit = jnp.where(cell >= 32, one << (cell - 32), 0)
    lo_mask = jnp.where(nz, lo_bit[None], 0).sum(
        axis=(1, 2), dtype=jnp.uint32
    ).reshape(B, K)
    hi_mask = jnp.where(nz, hi_bit[None], 0).sum(
        axis=(1, 2), dtype=jnp.uint32
    ).reshape(B, K)
    cand = counts == counts.min(axis=1, keepdims=True)
    FULL = jnp.uint32(0xFFFFFFFF)
    hi_m = jnp.where(cand, hi_mask, FULL)
    cand &= hi_m == hi_m.min(axis=1, keepdims=True)
    lo_m = jnp.where(cand, lo_mask, FULL)
    cand &= lo_m == lo_m.min(axis=1, keepdims=True)
    best_r = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first True
    return F.reshape(B, K, MAXD, MAXD)[
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)[:, 0], best_r
    ]


def solve_nodes_device(g, xs: list[int], config, edge_flows=None) -> dict[int, list]:
    """Batched device solver for all X-nodes in xs; mirrors oracle
    solve_node exactly (same block plan, margins, seeds,
    restart-selection, threshold).  One batch row per (node, block,
    restart).  Oversized nodes (degree > MAXD) use the host solver."""
    from shannon_tpu.oracle.sparseflow import node_blocks

    R = config.sf_restarts
    K = R + 1
    jobs = []  # (v, ins, outs, rows, cols, ab, bb, s, node_seed)
    result: dict[int, list] = {}
    for v in xs:
        ins, outs, a, b, s = _node_flows(g, v, edge_flows)
        if s <= 0:
            result[v] = []
            continue
        if len(ins) > MAXD or len(outs) > MAXD:
            result[v] = solve_node(g, v, config, edge_flows)
            continue
        result[v] = []
        node_seed = fnv1a(g.nodes[v].seq.encode()) ^ config.seed
        for rows, cols, ab, bb in node_blocks(a, b, config, s):
            jobs.append((v, ins, outs, rows, cols, ab, bb, s, node_seed))
    if not jobs:
        return result

    B = len(jobs)
    # small rounds go to the host solver (bit-identical pairings, tested
    # parity): SF iterates until no X-nodes remain, and the late rounds
    # of each bucket carry a handful of nodes, which the host solves in
    # microseconds.  The threshold of 32 was set against the first
    # accelerator's dispatch latency; not re-derived on the H100
    # (ROADMAP C1).
    if B <= 32:
        for v, *_rest in jobs:
            if not result[v]:
                result[v] = solve_node(g, v, config, edge_flows)
        return result
    # pad the batch to a power of two (min 64): B varies per round and
    # per bucket, and every distinct shape is a fresh XLA compile.
    # Zero-margin pad rows solve to all-zero flows.  ONE packed upload
    # (margins bitcast to int32 + per-job seed) and ONE
    # [B, MAXD, MAXD] download; restart expansion AND selection run on
    # device (batched_greedy_packed).
    B_pad = max(64, 1 << (B - 1).bit_length())
    buf = np.zeros((B_pad, 2 * MAXD + 1), np.int32)
    fbuf = buf[:, : 2 * MAXD].view(np.float32)
    sbuf = buf[:, 2 * MAXD :].view(np.uint32)
    for bi, (v, ins, outs, brows, bcols, ab, bb, s, node_seed) in enumerate(
        jobs
    ):
        fbuf[bi, : len(ab)] = ab
        fbuf[bi, MAXD : MAXD + len(bb)] = bb
        sbuf[bi, 0] = np.uint32(node_seed & 0xFFFFFFFF)
    F = np.asarray(
        batched_greedy_packed(jnp.asarray(buf), k_restarts=R)
    )  # [B_pad, MAXD, MAXD] — winning restart per job

    for bi, (v, ins, outs, brows, bcols, ab, bb, s, node_seed) in enumerate(
        jobs
    ):
        M, N = len(ab), len(bb)
        best_F = F[bi, :M, :N]
        thresh = np.float32(config.sf_min_flow_frac) * np.float32(s)
        result[v].extend(
            (ins[brows[i]], outs[bcols[j]], float(best_F[i, j]))
            for i, j in zip(*np.nonzero(best_F >= thresh))
        )
    return result
