"""Device read threading (reference hot loop #3/#4a — SURVEY.md §4.1):
map every read to its contig-path runs with batched binary searches +
run scans, replacing the per-read Python dict walk.

Spec (matches oracle thread_read_runs):
  * window j of a read 'hits' iff its oriented k-mer is an alive node;
  * consecutive hit windows are automatically consistent (an alive
    k-mer's successor within its contig is its unique graph successor),
    so a 'run' is a maximal stretch of hit windows;
  * within a run, a contig is recorded when the run starts or when the
    window's contig offset is 0 (boundary crossing; cycle revisits
    record again);
  * ALL runs are returned (read rescue — the host chooses all-runs or
    longest-run per config.rescue_reads).

Outputs (fixed shapes): event contig ids + event run ids [N, W],
event count [N], and per-run geometry [N, R]: first/last window index
in the read (p0, p1) and the contig offsets of those windows (o0, o1).
The geometry feeds insert-size-constrained pair joining (SURVEY.md §6
'long context'): fragment length implied by a candidate mate join is
computed from (p, o) anchors, so geometrically impossible joins are
rejected and multi-node gaps licensed by the insert distribution are
bridged (oracle/multibridge.join_pair_runs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.ops.condense import ContigArrays
from shannon_tpu.ops.kmers import extract_kmers, extract_kmers_packed
from shannon_tpu.ops.spectrum import lookup_hilo


@partial(jax.jit, static_argnames=("k",))
def thread_reads_device(
    codes: jnp.ndarray,  # [N, L] uint8
    lengths: jnp.ndarray,  # [N]
    ca: ContigArrays,
    k: int,
):
    """Returns (ev_cid [N, W], ev_run [N, W], n_events [N],
    run_p0, run_p1, run_o0, run_o1 — each [N, R], -1-padded)."""
    hi, lo, valid = extract_kmers(codes, lengths, k, canonical=False)
    return _thread_windows(hi, lo, valid, ca)


@partial(jax.jit, static_argnames=("k", "length"))
def thread_reads_device_packed(
    words: jnp.ndarray,  # [N, ceil(L/16)] uint32 (io.pack.pack_words)
    lengths: jnp.ndarray,
    ca: ContigArrays,
    k: int,
    length: int | None = None,
    mask: jnp.ndarray | None = None,
):
    """thread_reads_device over the 2-bit transfer format — identical
    output; 3.6x fewer upload bytes than raw uint8 codes."""
    hi, lo, valid = extract_kmers_packed(
        words, lengths, k, canonical=False, length=length, mask=mask
    )
    return _thread_windows(hi, lo, valid, ca)


def slice_nodes_for_threading(ca: ContigArrays) -> ContigArrays:
    """Driver-level (host) shrink of the node table to the tight grid
    around its REAL node count: the threading join's sort cost scales
    with (table + query) lanes, and the post-clip table capacity
    carries up to ~50% SENTINEL padding that the join would sort every
    batch.  Node lanes are front-compacted + sorted, so a prefix slice
    is exact; contig-indexed fields are sliced alongside (threading
    reads only node_* fields, but a consistent pytree keeps jit
    caching simple).  No device compute — array views only."""
    from shannon_tpu.ops.count import tight_capacity

    n = int(ca.n_nodes)
    cap = tight_capacity(n, minimum=1 << 14)
    if cap >= ca.node_hi.shape[0]:
        return ca
    return ContigArrays(
        node_hi=ca.node_hi[:cap],
        node_lo=ca.node_lo[:cap],
        node_count=ca.node_count[:cap],
        node_cid=ca.node_cid[:cap],
        node_off=ca.node_off[:cap],
        klen=ca.klen[:cap],
        count_sum=ca.count_sum[:cap],
        head_lane=ca.head_lane[:cap],
        tail_lane=ca.tail_lane[:cap],
        out_edges=ca.out_edges[:, :cap],
        rc_pair=ca.rc_pair[:cap],
        n_nodes=ca.n_nodes,
        n_contigs=ca.n_contigs,
    )


def _thread_windows(hi, lo, valid, ca: ContigArrays):
    """Shared threading body on extracted window k-mers."""
    N, W = hi.shape
    idx, hit = lookup_hilo(
        ca.node_hi, ca.node_lo, hi.reshape(-1), lo.reshape(-1)
    )
    idx = idx.reshape(N, W)
    hit = (hit.reshape(N, W)) & valid
    cid = jnp.where(hit, ca.node_cid[idx], -1)
    off = jnp.where(hit, ca.node_off[idx], -1)

    prev_hit = jnp.pad(hit[:, :-1], ((0, 0), (1, 0)), constant_values=False)
    next_hit = jnp.pad(hit[:, 1:], ((0, 0), (0, 1)), constant_values=False)
    run_start = hit & ~prev_hit
    run_end = hit & ~next_hit
    run_id = jnp.cumsum(run_start.astype(jnp.int32), axis=1) - 1
    run_id = jnp.where(hit, run_id, -1)

    # Per-row compaction via FLAT sorts with (row, flagged-col) packed
    # into one uint32 key — one flat sort of all lanes rather than a
    # scatter or batched row-wise sorts (the inherited choice of
    # ops/count._unique_reduce; ROADMAP C1).  Column bits size to
    # the window count (8 bits at the classic 128-base pad, 9 at a
    # 150bp library's 160-base pad, ...), so any (batch, read-length)
    # with row_bits + col_bits + 1 <= 32 packs — at the default
    # batch_reads = 2^16 that allows reads up to ~32k bases.
    col_bits = max((W - 1).bit_length(), 1) + 1  # +1 for the flag bit
    row_bits = max((N - 1).bit_length(), 1)
    if row_bits + col_bits > 32:
        raise ValueError(
            f"threading key overflow: batch of {N} reads x {W} windows "
            "needs >32 key bits; lower batch_reads or read_pad_length"
        )
    col = jax.lax.broadcasted_iota(jnp.uint32, (N, W), 1)
    row = jax.lax.broadcasted_iota(jnp.uint32, (N, W), 0)
    base = row << jnp.uint32(col_bits)
    FLAG = jnp.uint32(1 << (col_bits - 1))

    def row_compact(flag: jnp.ndarray, payloads: tuple) -> tuple:
        key = base | jnp.where(flag, col, col | FLAG)
        flat = jax.lax.sort(
            (key.reshape(-1), *(p.reshape(-1) for p in payloads)),
            num_keys=1,
        )
        return tuple(p.reshape(N, W) for p in flat[1:])

    is_event = hit & (run_start | (off == 0))
    ev_cid, ev_run = row_compact(is_event, (cid, run_id))
    n_events = is_event.sum(axis=1).astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (N, W), 1)
    ev_cid = jnp.where(idx < n_events[:, None], ev_cid, -1)
    ev_run = jnp.where(idx < n_events[:, None], ev_run, -1)

    # per-run geometry: compact run starts and run ends per row; run r
    # spans columns [start_r, end_r] (contiguous hits); the contig
    # offsets of those two anchor windows ride the same sorts
    max_runs = (W + 1) // 2 + 1
    s_pos, s_off = row_compact(run_start, (idx, off))
    e_pos, e_off = row_compact(run_end, (idx, off))
    n_runs = run_start.sum(axis=1).astype(jnp.int32)
    ridx = jax.lax.broadcasted_iota(jnp.int32, (N, max_runs), 1)
    valid_r = ridx < n_runs[:, None]
    run_p0 = jnp.where(valid_r, s_pos[:, :max_runs], -1)
    run_p1 = jnp.where(valid_r, e_pos[:, :max_runs], -1)
    run_o0 = jnp.where(valid_r, s_off[:, :max_runs], -1)
    run_o1 = jnp.where(valid_r, e_off[:, :max_runs], -1)
    return ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1


@jax.jit
def compact_thread_outputs(
    ev_cid: jnp.ndarray,
    ev_run: jnp.ndarray,
    n_events: jnp.ndarray,
    run_p0: jnp.ndarray,
    run_p1: jnp.ndarray,
    run_o0: jnp.ndarray,
    run_o1: jnp.ndarray,
):
    """ACROSS-READ compaction of the threading outputs: one flat
    position-key sort packs every real event (and every real run) to
    the front in (read, position) order.  A per-read padded download
    is ~26MB per 65k-read batch at ~4 real events per read — the
    padding, not the content.  Returns the compacted flat arrays plus
    per-row and total counts; pack_evidence slices them to the counted
    capacity for one small download."""
    N, W = ev_cid.shape
    MSB = jnp.uint32(0x80000000)
    pos_e = jax.lax.broadcasted_iota(jnp.uint32, (N * W, 1), 0)[:, 0]
    valid_e = (ev_cid >= 0).reshape(-1)
    key_e = jnp.where(valid_e, pos_e, pos_e | MSB)
    _, c_cid, c_run = jax.lax.sort(
        (key_e, ev_cid.reshape(-1), ev_run.reshape(-1)), num_keys=1
    )
    tot_e = valid_e.sum(dtype=jnp.int32)
    R = run_p0.shape[1]
    pos_r = jax.lax.broadcasted_iota(jnp.uint32, (N * R, 1), 0)[:, 0]
    valid_r = (run_p0 >= 0).reshape(-1)
    key_r = jnp.where(valid_r, pos_r, pos_r | MSB)
    _, c_p0, c_p1, c_o0, c_o1 = jax.lax.sort(
        (
            key_r,
            run_p0.reshape(-1),
            run_p1.reshape(-1),
            run_o0.reshape(-1),
            run_o1.reshape(-1),
        ),
        num_keys=1,
    )
    tot_r = valid_r.sum(dtype=jnp.int32)
    n_runs = (run_p0 >= 0).sum(axis=1).astype(jnp.int32)
    return c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_runs, jnp.stack(
        [tot_e, tot_r]
    )


@partial(jax.jit, static_argnames=("cap_e", "cap_r"))
def pack_evidence(
    c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_events, n_runs, lengths,
    cap_e: int, cap_r: int,
) -> jnp.ndarray:
    """One int32 download buffer for a batch's compacted evidence.
    cap_e/cap_r come from the counted totals rounded to the
    {2^k, 1.5*2^k} grid (compile-cache-stable, <=50% slack, always
    even so int16 fields pair).  Layout: ev_cid[cap_e] | run_o0[cap_r]
    | run_o1[cap_r] | (p0,p1) int16 pairs [cap_r] | ev_run int16 pairs
    [cap_e/2] | n_events[N] | n_runs[N] | lengths[N]."""
    run16 = c_run[:cap_e].astype(jnp.int16).reshape(cap_e // 2, 2)
    ev_run_p = jax.lax.bitcast_convert_type(run16, jnp.int32)
    p16 = jnp.stack(
        [c_p0[:cap_r].astype(jnp.int16), c_p1[:cap_r].astype(jnp.int16)],
        axis=1,
    )
    p_pack = jax.lax.bitcast_convert_type(p16, jnp.int32)
    return jnp.concatenate(
        [
            c_cid[:cap_e],
            c_o0[:cap_r],
            c_o1[:cap_r],
            p_pack,
            ev_run_p,
            n_events.astype(jnp.int32),
            n_runs,
            lengths.astype(jnp.int32),
        ]
    )


def evidence_grid(n: int, minimum: int = 1 << 12) -> int:
    """Smallest even {2^k, 1.5*2^k} grid point >= n (capacity for
    pack_evidence slices; grid keeps the compiled shape set small)."""
    want = max(int(n), minimum)
    p = 1 << (want - 1).bit_length()
    c = p // 4 * 3
    return c if c >= want else p


def unpack_evidence(
    buf: np.ndarray, cap_e: int, cap_r: int, n_rows: int
) -> dict[str, np.ndarray]:
    """Host-side split of pack_evidence's buffer back into RECTANGULAR
    per-read arrays (the exact shapes runs_to_flat_paths /
    paths_to_lists consume), sized to the batch's true max events/runs
    per read — a cheap numpy scatter over the tiny downloaded stream."""
    buf = np.asarray(buf)
    c = 0
    ev_cid_f = buf[c : c + cap_e]; c += cap_e
    run_o0_f = buf[c : c + cap_r]; c += cap_r
    run_o1_f = buf[c : c + cap_r]; c += cap_r
    p_pack = buf[c : c + cap_r]; c += cap_r
    ev_run_p = buf[c : c + cap_e // 2]; c += cap_e // 2
    n_events = buf[c : c + n_rows]; c += n_rows
    n_runs = buf[c : c + n_rows]; c += n_rows
    lengths = buf[c : c + n_rows]
    ev_run_f = (
        np.ascontiguousarray(ev_run_p).view(np.int16).astype(np.int32)
    )
    p16 = np.ascontiguousarray(p_pack).view(np.int16).reshape(-1, 2)
    run_p0_f = p16[:, 0].astype(np.int32)
    run_p1_f = p16[:, 1].astype(np.int32)

    def rect(flat: np.ndarray, counts: np.ndarray, width: int) -> np.ndarray:
        out = np.full((n_rows, max(width, 0)), -1, np.int32)
        total = int(counts.sum())
        row_of = np.repeat(np.arange(n_rows), counts)
        col = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        out[row_of, col] = flat[:total]
        return out

    w = int(n_events.max(initial=0))
    r = int(n_runs.max(initial=0))
    return {
        "ev_cid": rect(ev_cid_f, n_events, w),
        "ev_run": rect(ev_run_f, n_events, w),
        "n_events": n_events.astype(np.int32),
        "run_p0": rect(run_p0_f, n_runs, r),
        "run_p1": rect(run_p1_f, n_runs, r),
        "run_o0": rect(run_o0_f, n_runs, r),
        "run_o1": rect(run_o1_f, n_runs, r),
        "n_runs": n_runs.astype(np.int32),
        "lengths": lengths.astype(np.int32),
    }


def runs_to_flat_paths(
    ev_cid: np.ndarray,
    ev_run: np.ndarray,
    n_events: np.ndarray,
    run_p0: np.ndarray,
    run_p1: np.ndarray,
    rc_pair: np.ndarray | None,
    rescue: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized single-end evidence construction: device threading
    rows -> flat path arrays (flat node ids, row offsets, unit weights),
    with each path followed by its reverse-complement twin when rc_pair
    is given — the array equivalent of paths_to_lists + expand_paths
    for the unpaired mode (a per-row Python loop would be read-scale).
    Emission order matches
    expand_paths exactly: read-major, runs in read order, forward then
    RC; duplicate paths merge downstream in NodeGraph._dedup_rows."""
    N, w = ev_cid.shape
    col = np.arange(w, dtype=np.int32)[None, :]
    valid = col < n_events[:, None]
    if not rescue:
        windows = np.where(run_p0 != -1, run_p1 - run_p0, -1)
        best = windows.argmax(axis=1).astype(np.int32)  # ties: earliest
        valid &= ev_run == best[:, None]
    if not valid.any():
        z = np.empty(0, np.int64)
        return z, np.zeros(1, np.int64), z
    prev_run = np.empty_like(ev_run)
    prev_run[:, 0] = -2
    prev_run[:, 1:] = ev_run[:, :-1]
    start2d = valid & ((col == 0) | (ev_run != prev_run))
    flat = ev_cid[valid].astype(np.int64)
    starts = start2d[valid]
    path_id = np.cumsum(starts) - 1
    lens = np.bincount(path_id).astype(np.int64)
    n_paths = len(lens)
    offs = np.zeros(n_paths + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if rc_pair is None:
        return flat, offs, np.ones(n_paths, np.int64)
    total = len(flat)
    lens2 = np.repeat(lens, 2)
    offs2 = np.zeros(2 * n_paths + 1, np.int64)
    np.cumsum(lens2, out=offs2[1:])
    out = np.empty(2 * total, np.int64)
    within = np.arange(total, dtype=np.int64) - offs[path_id]
    out[offs2[2 * path_id] + within] = flat
    rev = flat[offs[path_id] + lens[path_id] - 1 - within]
    out[offs2[2 * path_id + 1] + within] = np.asarray(rc_pair, np.int64)[rev]
    return out, offs2, np.ones(2 * n_paths, np.int64)


def paths_to_lists(
    ev_cid: np.ndarray,
    ev_run: np.ndarray,
    n_events: np.ndarray,
    run_p0: np.ndarray,
    run_p1: np.ndarray,
    run_o0: np.ndarray,
    run_o1: np.ndarray,
    rescue: bool = True,
) -> list[list]:
    """Host conversion to per-read Run lists (aligned with batch rows;
    [] = unthreadable read): [[Run0, Run1, ...], ...] with each Run
    carrying (path, p0, p1, o0, o1) — see oracle.multibridge.Run.
    rescue=False keeps only each read's longest run (by window count
    p1 - p0 + 1, ties -> earliest)."""
    from shannon_tpu.oracle.multibridge import Run

    ev_cid = np.asarray(ev_cid)
    ev_run = np.asarray(ev_run)
    n_events = np.asarray(n_events)
    run_p0 = np.asarray(run_p0)
    run_p1 = np.asarray(run_p1)
    run_o0 = np.asarray(run_o0)
    run_o1 = np.asarray(run_o1)
    out: list[list] = []
    for i in range(ev_cid.shape[0]):
        n = int(n_events[i])
        if n == 0:
            out.append([])
            continue
        cids = ev_cid[i, :n]
        rids = ev_run[i, :n]
        # split events into runs at run-id changes
        cuts = np.nonzero(np.diff(rids))[0] + 1
        paths = [seg.tolist() for seg in np.split(cids, cuts)]
        run_ids = [int(rids[0])] + [int(rids[c]) for c in cuts]
        runs = [
            Run(
                path=paths[t],
                p0=int(run_p0[i, r]),
                p1=int(run_p1[i, r]),
                o0=int(run_o0[i, r]),
                o1=int(run_o1[i, r]),
            )
            for t, r in enumerate(run_ids)
        ]
        if rescue:
            out.append(runs)
        else:
            best = max(
                range(len(runs)),
                key=lambda t: (runs[t].p1 - runs[t].p0, -t),
            )
            out.append([runs[best]])
    return out
