"""Device de Bruijn graph condensation via pointer-jumping
(SURVEY.md §8 M2: 'condensation (pointer-jumping / segment ops)').

Replaces the reference's dict-walk unitig construction (SURVEY.md §4.2)
with fixed-shape array passes:

  1. oriented node table: both orientations of every alive canonical
     k-mer, sorted + deduped (palindromes collapse; max-reduce keeps the
     canonical count);
  2. successor/predecessor probes (4 + 4 binary searches per node) give
     degrees and mergeable links (out==1 into in==1);
  3. isolated cycles are broken at their minimum-index node, detected by
     min-propagating pointer doubling;
  4. plain pointer doubling labels every node with its unitig head and
     offset; segment scatter-adds give per-contig k-mer length and
     exact count sum (the host divides them into the float32 mean
     abundance, to_contig_graph);
  5. tail-node probes emit the contig-level edge lists [n, 4].

All shapes are static in the node capacity (2x spectrum capacity);
contig-indexed outputs live in the first n_contigs lanes.

Oracle parity target: shannon_tpu.oracle.graph.build_contigs (tested as
(seq, abundance, edges) set equality in tests/test_condense_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.ops.count import Spectrum
from shannon_tpu.ops.kmers import SENTINEL, revcomp_hilo
from shannon_tpu.ops.spectrum import lookup_hilo


@jax.tree_util.register_pytree_node_class
@dataclass
class ContigArrays:
    """Device contig graph.  Node lanes: capacity C2; contig-indexed
    arrays are valid in lanes [0, n_contigs)."""

    # per oriented node
    node_hi: jnp.ndarray  # [C2] uint32 (SENTINEL pad)
    node_lo: jnp.ndarray
    node_count: jnp.ndarray  # [C2] int32
    node_cid: jnp.ndarray  # [C2] int32 contig id (or -1 pad)
    node_off: jnp.ndarray  # [C2] int32 offset within contig
    # per contig
    klen: jnp.ndarray  # [C2] int32 #member k-mers
    count_sum: jnp.ndarray  # [C2] int32 exact sum of member counts
    # (abundance == float32(count_sum)/float32(klen), divided on the
    # host: the exact integer sum gives the oracle's bits there)
    head_lane: jnp.ndarray  # [C2] int32 node lane of first k-mer
    tail_lane: jnp.ndarray  # [C2] int32 node lane of last k-mer
    out_edges: jnp.ndarray  # [4, C2] int32 successor cid or -1, base-first
    rc_pair: jnp.ndarray  # [C2] int32 reverse-complement twin cid
    n_nodes: jnp.ndarray  # [] int32
    n_contigs: jnp.ndarray  # [] int32

    def tree_flatten(self):
        return (
            self.node_hi, self.node_lo, self.node_count, self.node_cid,
            self.node_off, self.klen, self.count_sum,
            self.head_lane, self.tail_lane, self.out_edges, self.rc_pair,
            self.n_nodes, self.n_contigs,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@partial(jax.jit, static_argnames=("k", "canonical"))
def _nodes_stage(spec: Spectrum, k: int, canonical: bool):
    """Stage A: oriented node table (both strands, palindromes deduped)."""
    C = spec.capacity
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    if canonical:
        from shannon_tpu.ops.count import unique_first_sorted

        rhi, rlo = revcomp_hilo(spec.hi, spec.lo, k)
        rhi = jnp.where(pad, SENTINEL, rhi)
        rlo = jnp.where(pad, SENTINEL, rlo)
        thi = jnp.concatenate([spec.hi, rhi])
        tlo = jnp.concatenate([spec.lo, rlo])
        tcnt = jnp.concatenate([spec.count, spec.count])
        thi, tlo, tcnt = jax.lax.sort((thi, tlo, tcnt), num_keys=2)
        # dedupe palindromes (duplicate keys carry identical counts, so
        # first-of-run == max-of-run); scatter-free compaction
        C2 = 2 * C
        node_hi, node_lo, (node_count,), n_nodes = unique_first_sorted(
            thi, tlo, (tcnt,), C2
        )
    else:
        node_hi, node_lo, node_count = spec.hi, spec.lo, spec.count
        n_nodes = spec.n
    return node_hi, node_lo, node_count, n_nodes


@partial(jax.jit, static_argnames=("k",))
def _links_stage(node_hi, node_lo, k: int):
    """Stage B: degrees + mergeable links + successor directory from a
    single (k-1)-mer GROUP JOIN.

    Every edge u -> v is 'suffix_{k-1}(u) == prefix_{k-1}(v)', so one
    sort of 2*C2 records — each node contributes its suffix key (as
    source) and its prefix key (as target) — groups every edge
    endpoint: within a group of equal (k-1)-mers with S sources and P
    targets, outdeg(source) = P, indeg(target) = S, and the mergeable
    next/prev link exists exactly when S == P == 1.  This replaces the
    4-probe sort-merge join (5*C2 lanes) + degree scatters (100M+
    updates) of the earlier designs: links was 15.1s of the 1M-read
    condensation as a two-sided join, 10.0s with scatter-derived
    degrees, and the group join sorts 2*C2 lanes once.

    Returns (next_link, prev_link, rec_lane, firstP, p_cnt):
    rec_lane[2*C2] is the sorted records' node-lane payload, and
    firstP/p_cnt[C2] point each node at its successor run inside it —
    the reduce stage gathers tail-contig edges from this directory
    instead of a probe table."""
    C2 = node_hi.shape[0]
    m = 2 * C2
    pad = (node_hi == SENTINEL) & (node_lo == SENTINEL)
    # suffix key: low 2(k-1) bits;  prefix key: value >> 2
    sb = 2 * (k - 1)
    if sb > 32:
        suf_h = node_hi & jnp.uint32((1 << (sb - 32)) - 1)
        suf_l = node_lo
    else:
        suf_h = jnp.zeros_like(node_hi)
        suf_l = (
            node_lo
            if sb == 32
            else node_lo & jnp.uint32((1 << sb) - 1)
        )
    pre_h = node_hi >> 2
    pre_l = (node_lo >> 2) | (node_hi << 30)
    # pads carry the all-ones key (unreachable: real keys < 2^60)
    suf_h = jnp.where(pad, SENTINEL, suf_h)
    suf_l = jnp.where(pad, SENTINEL, suf_l)
    pre_h = jnp.where(pad, SENTINEL, pre_h)
    pre_l = jnp.where(pad, SENTINEL, pre_l)

    lane = jax.lax.broadcasted_iota(jnp.int32, (C2, 1), 0)[:, 0]
    kh = jnp.concatenate([suf_h, pre_h])
    kl = jnp.concatenate([suf_l, pre_l])
    side = jnp.concatenate(
        [jnp.zeros(C2, jnp.uint32), jnp.ones(C2, jnp.uint32)]
    )
    kh, kl, side_s, lane_s = jax.lax.sort(
        (kh, kl, side, jnp.concatenate([lane, lane])), num_keys=3
    )

    iota_m = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    valid = ~((kh == SENTINEL) & (kl == SENTINEL))
    new_group = jnp.ones(m, bool).at[1:].set(
        (kh[1:] != kh[:-1]) | (kl[1:] != kl[:-1])
    )
    g0 = jax.lax.cummax(jnp.where(new_group, iota_m, 0))
    is_last = jnp.ones(m, bool).at[:-1].set(new_group[1:])
    end = -jnp.flip(
        jax.lax.cummax(jnp.flip(-jnp.where(is_last, iota_m, m)))
    )
    c0 = jnp.cumsum((side_s == 0).astype(jnp.int32))  # inclusive
    c0_before = jnp.where(g0 > 0, c0[jnp.clip(g0 - 1, 0, m - 1)], 0)
    s_cnt = c0[jnp.clip(end, 0, m - 1)] - c0_before
    p_cnt = (end - g0 + 1) - s_cnt
    firstP = g0 + s_cnt

    single = valid & (s_cnt == 1) & (p_cnt == 1)
    next_cand = jnp.where(
        single & (side_s == 0),
        lane_s[jnp.clip(firstP, 0, m - 1)],
        -1,
    )
    prev_cand = jnp.where(single & (side_s == 1), lane_s[g0], -1)
    fp_out = jnp.where((side_s == 0) & valid, firstP, 0)
    pc_out = jnp.where((side_s == 0) & valid, p_cnt, 0)

    # unsort: every table lane has exactly two records (suffix then
    # prefix under key lane*2 + side).  Permutation sort + gathers, not
    # a 5-operand sort: a wide sort's transient memory scales with its
    # operand count (see tipclip._device_clip_remap).
    key2 = (lane_s.astype(jnp.uint32) << 1) | side_s
    _, perm = jax.lax.sort((key2, iota_m), num_keys=1)
    next_link = next_cand[perm[0::2]]
    prev_link = prev_cand[perm[1::2]]
    firstP_lane = fp_out[perm[0::2]]
    pcnt_lane = pc_out[perm[0::2]]
    return next_link, prev_link, lane_s, firstP_lane, pcnt_lane


def build_contig_arrays(spec: Spectrum, k: int, canonical: bool = True) -> ContigArrays:
    """Device programs (node table, links, labeling, reduction) —
    smaller peak memory than one fused program at multi-million-node
    scale, and failures bisect to a stage.

    Labeling uses an early-exit while_loop: chains converge in
    ceil(log2(longest chain)) pointer-doubling rounds (~11 at pipeline
    scale vs 2 x 23 fixed rounds of a fori_loop).  Cycles never
    converge, so the label
    pass also reports whether any cycle exists; only then does the
    min-propagation cycle-breaking pass (full log2(C2) rounds) run,
    followed by one more label pass on the cut links."""
    node_hi, node_lo, node_count, n_nodes = _nodes_stage(spec, k, canonical)
    next_link, prev_link, rec_lane, firstP, p_cnt = _links_stage(
        node_hi, node_lo, k
    )
    ptr, dist, has_cycle = _label_stage(prev_link)
    if bool(has_cycle):
        prev2 = _cycle_fix(prev_link)
        ptr, dist, _ = _label_stage(prev2)
    else:
        prev2 = prev_link
    return _reduce_stage(
        node_hi, node_lo, node_count, n_nodes,
        prev2, ptr, dist, rec_lane, firstP, p_cnt, k, canonical,
    )


@jax.jit
def _label_stage(prev_link):
    """Pointer-doubling head/offset labeling with early exit.  Returns
    (head pointer, offset, any-cycle flag).  For acyclic links the loop
    exits once every pointer is a fixpoint; lanes on cycles never fix,
    so the loop is capped at log2(C2) rounds and the flag (their root
    still has a predecessor) is exact either way: a capped run has
    advanced every chain lane to its true head (any chain fits in C2
    doubling steps), so only cycle lanes can still see prev >= 0."""
    C2 = prev_link.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (C2, 1), 0)[:, 0]
    n_rounds = max(C2.bit_length(), 1)
    ptr0 = jnp.where(prev_link >= 0, prev_link, iota)
    dist0 = jnp.where(prev_link >= 0, 1, 0)

    def cond(st):
        r, _ptr, _dist, changed = st
        return changed & (r < n_rounds)

    def body(st):
        r, ptr, dist, _ = st
        nd = dist + dist[ptr]
        np_ = ptr[ptr]
        return r + 1, np_, nd, jnp.any(np_ != ptr)

    _, ptr, dist, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), ptr0, dist0, jnp.bool_(True))
    )
    has_cycle = jnp.any(prev_link[ptr] >= 0)
    return ptr, dist, has_cycle


@jax.jit
def _cycle_fix(prev_link):
    """Break isolated cycles at their min-index node: min-propagating
    pointer doubling (full log2(C2) rounds — a cycle's min must travel
    the whole cycle).  Returns the cut link array (cycle heads get
    prev = -1).  Only runs when _label_stage reported a cycle."""
    C2 = prev_link.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (C2, 1), 0)[:, 0]
    n_rounds = max(C2.bit_length(), 1)
    ptr = jnp.where(prev_link >= 0, prev_link, iota)
    mn = iota

    def cyc_body(_, st):
        ptr, mn = st
        mn = jnp.minimum(mn, mn[ptr])
        return ptr[ptr], mn

    ptr, mn = jax.lax.fori_loop(0, n_rounds, cyc_body, (ptr, mn))
    is_cycle = prev_link[ptr] >= 0  # root still has a predecessor
    cycle_head = is_cycle & (mn == iota)
    return jnp.where(cycle_head, -1, prev_link)


@partial(jax.jit, static_argnames=("k", "canonical"))
def _reduce_stage(
    node_hi, node_lo, node_count, n_nodes,
    prev2, head_ptr, dist, rec_lane, firstP, p_cnt, k: int, canonical: bool,
) -> ContigArrays:
    """Per-contig reductions, edges, rc pairing from the labeled nodes."""
    C2 = node_hi.shape[0]
    real = ~((node_hi == SENTINEL) & (node_lo == SENTINEL))
    iota = jax.lax.broadcasted_iota(jnp.int32, (C2, 1), 0)[:, 0]

    head = head_ptr
    is_head = real & (prev2 < 0)

    # contig ids: rank of head lanes in lane order
    head_rank = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    n_contigs = is_head.sum(dtype=jnp.int32)
    cid_of_lane = jnp.where(is_head, head_rank, -1)
    node_cid = jnp.where(real, cid_of_lane[head], -1)

    # ---- per-contig reductions ---------------------------------------
    # Sort nodes by (cid, offset); run i of the sorted order IS contig i
    # (cids are dense head ranks).  Per-run head/tail/klen/count-sum are
    # then extracted with two compaction SORTS (run starts to the front,
    # run ends to the front), the inherited choice of
    # ops/count._unique_reduce (ROADMAP C1).  These sorts carry their
    # payloads; the permutation form (sort keys, gather payloads) is
    # kept for the programs whose wide sorts need the smaller
    # transient: tipclip._device_clip_remap and the links unsort.
    BIG = jnp.int32(0x7FFFFFFF)
    key_cid = jnp.where(real, node_cid, BIG)
    s_cid, s_off, s_lane, s_cnt = jax.lax.sort(
        (key_cid, jnp.where(real, dist, 0), iota, node_count), num_keys=2
    )
    prev_diff = jnp.ones(C2, bool).at[1:].set(s_cid[1:] != s_cid[:-1])
    next_diff = jnp.ones(C2, bool).at[:-1].set(s_cid[1:] != s_cid[:-1])
    # pad lanes form their own run, clamping the last real run's end
    s_real = s_cid != BIG
    r_start = prev_diff
    r_end = next_diff
    pos = jax.lax.broadcasted_iota(jnp.uint32, (C2, 1), 0)[:, 0]
    ccb = jnp.cumsum(s_cnt.astype(jnp.int32)) - s_cnt  # counts before lane

    MSB = jnp.uint32(0x80000000)
    skey_s = jnp.where(r_start & s_real, pos, pos | MSB)
    _, h_lane, h_pos, h_cb = jax.lax.sort(
        (skey_s, s_lane, pos.astype(jnp.int32), ccb), num_keys=1
    )
    skey_e = jnp.where(r_end & s_real, pos, pos | MSB)
    _, e_lane_c, e_pos, e_ce = jax.lax.sort(
        (
            skey_e,
            s_lane,
            pos.astype(jnp.int32),
            ccb + s_cnt,  # counts through lane (inclusive)
        ),
        num_keys=1,
    )
    valid_c = jnp.arange(C2, dtype=jnp.int32) < n_contigs
    head_lane = jnp.where(valid_c, h_lane, -1)
    tail_lane = jnp.where(valid_c, e_lane_c, -1)
    klen = jnp.where(valid_c, e_pos - h_pos + 1, 0)
    csum = jnp.where(valid_c, e_ce - h_cb, 0)
    # ---- 5. contig edges from the links stage's successor directory
    # (packed at the leading lanes of the [4, C2] edge array; every
    # consumer treats -1 as absent, none indexes by base)
    tl = jnp.clip(tail_lane, 0, C2 - 1)
    m = rec_lane.shape[0]
    fp_t = firstP[tl]
    pc_t = p_cnt[tl]
    edge_rows = []
    for j in range(4):
        v_lane = rec_lane[jnp.clip(fp_t + j, 0, m - 1)]
        hit_j = (j < pc_t) & (tail_lane >= 0)
        edge_rows.append(
            jnp.where(hit_j, node_cid[jnp.clip(v_lane, 0, C2 - 1)], -1)
        )
    out_edges = jnp.stack(edge_rows, axis=0)

    # ---- 6. reverse-complement twin: the contig whose first k-mer is
    # revcomp(this contig's last k-mer) (canonical mode; self in
    # strand-specific / palindromic cases)
    cid_iota32 = jax.lax.broadcasted_iota(jnp.int32, (C2, 1), 0)[:, 0]
    if canonical:
        t_hi = node_hi[tl]
        t_lo = node_lo[tl]
        rc_h, rc_l = revcomp_hilo(t_hi, t_lo, k)
        rc_idx, rc_hit = lookup_hilo(node_hi, node_lo, rc_h, rc_l)
        # the rc k-mer must be a contig HEAD (offset 0): in a broken
        # cycle the rc of a tail k-mer can land mid-contig, where no
        # aligned rc twin exists (oracle falls back to self there)
        rc_is_head = dist[jnp.clip(rc_idx, 0, C2 - 1)] == 0
        rc_pair = jnp.where(
            (tail_lane >= 0) & rc_hit & rc_is_head,
            node_cid[rc_idx],
            cid_iota32,
        )
    else:
        rc_pair = cid_iota32

    return ContigArrays(
        node_hi=node_hi,
        node_lo=node_lo,
        node_count=node_count,
        node_cid=node_cid,
        node_off=jnp.where(real, dist, -1),
        klen=klen,
        count_sum=csum,
        head_lane=head_lane,
        tail_lane=tail_lane,
        out_edges=out_edges,
        rc_pair=rc_pair,
        n_nodes=n_nodes,
        n_contigs=n_contigs,
    )


# ---------------------------------------------------------------------
# host-side materialization (sequences + ContigGraph for the assembler)
# ---------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k",))
def contig_base_streams(ca: ContigArrays, k: int):
    """Device-side sequence packing: (tails, heads) where tails[:sum klen]
    is every node's LAST base code in (cid, offset) order — i.e. the
    concatenated per-contig tail-base runs — and heads[c] is contig c's
    k-1 leading base codes.  Lets the host fetch ~1 byte/base instead of
    the full node tables (node_cid/off/hi/lo at table capacity are a
    ~32MB download for a 2M-lane table)."""
    C2 = ca.node_hi.shape[0]
    real = ca.node_cid >= 0
    BIG = jnp.int32(0x7FFFFFFF)
    key_cid = jnp.where(real, ca.node_cid, BIG)
    base = (ca.node_lo & 3).astype(jnp.int32)
    _, _, tails = jax.lax.sort(
        (key_cid, jnp.where(real, ca.node_off, 0), base), num_keys=2
    )
    hl = jnp.clip(ca.head_lane, 0, C2 - 1)
    h_hi = ca.node_hi[hl]
    h_lo = ca.node_lo[hl]
    cols = []
    for j in range(k - 1):
        shift = 2 * (k - 1 - j)
        if shift >= 32:
            b = h_hi >> (shift - 32)
        else:
            b = (h_lo >> shift) | (h_hi << (32 - shift))
        cols.append((b & 3).astype(jnp.uint8))
    heads = jnp.stack(cols, axis=1)  # [C2, k-1]
    return tails.astype(jnp.uint8), heads


def contig_sequences(ca: ContigArrays, k: int) -> list[str]:
    """Host reconstruction of contig base strings from the device base
    streams (see contig_base_streams)."""
    n_contigs = int(ca.n_contigs)
    klen = np.asarray(ca.klen[:n_contigs], dtype=np.int64)
    tails_dev, heads_dev = contig_base_streams(ca, k)
    total_tails = int(klen.sum())
    tails = np.asarray(tails_dev[:total_tails])
    heads = np.asarray(heads_dev[:n_contigs])

    lengths = klen + k - 1
    starts = np.zeros(n_contigs + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    buf = np.zeros(int(starts[-1]), dtype=np.uint8)
    # contig c = heads[c] (k-1 leading bases) + its tail-base run
    idx_h = starts[:-1][:, None] + np.arange(k - 1, dtype=np.int64)[None, :]
    buf[idx_h.ravel()] = heads.ravel()
    tcum = np.zeros(n_contigs, dtype=np.int64)
    np.cumsum(klen[:-1], out=tcum[1:])
    within = np.arange(total_tails, dtype=np.int64) - np.repeat(tcum, klen)
    buf[np.repeat(starts[:-1] + k - 1, klen) + within] = tails
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    chars = lut[buf]
    return [
        chars[starts[i] : starts[i + 1]].tobytes().decode("ascii")
        for i in range(n_contigs)
    ]


def to_contig_graph(
    ca: ContigArrays, k: int, config, with_kmers: bool = False
) -> "ContigGraph":
    """Materialize the oracle-format ContigGraph (sequences, edges, rc
    pairing) from device arrays, so the host assembly stages (MB/SF)
    run unchanged.  with_kmers additionally builds per-contig k-mer
    lists and the kmer->(cid, off) dict (only needed by the oracle
    threading path and parity tests — it is a Python-scale loop over
    every node, so the device pipeline skips it)."""
    from shannon_tpu.oracle.graph import Contig, ContigGraph

    n_contigs = int(ca.n_contigs)
    seqs = contig_sequences(ca, k)
    klens = np.asarray(ca.klen[:n_contigs])
    # the spec's float32 mean, divided here in numpy from the exact
    # integer sums: the host division is IEEE whatever the device's is
    abund = np.float32(np.asarray(ca.count_sum[:n_contigs])) / np.float32(
        np.maximum(klens, 1)
    )

    if with_kmers:
        node_cid = np.asarray(ca.node_cid)
        node_off = np.asarray(ca.node_off)
        node_hi = np.asarray(ca.node_hi, dtype=np.uint64)
        node_lo = np.asarray(ca.node_lo, dtype=np.uint64)
        real = node_cid >= 0
        vals = ((node_hi << np.uint64(32)) | node_lo)[real]
        cids = node_cid[real]
        offs = node_off[real]
        kmer_lists: list[list[int]] = [[0] * int(l) for l in klens]
        for v, c, o in zip(vals.tolist(), cids.tolist(), offs.tolist()):
            kmer_lists[c][o] = v
    else:
        kmer_lists = [[] for _ in range(n_contigs)]

    contigs = [
        Contig(
            kmers=kmer_lists[i], seq=seqs[i],
            abundance=float(abund[i]),
        )
        for i in range(n_contigs)
    ]
    # patch klen-dependent uses: Contig.kmers may be empty, so NodeGraph
    # construction reads klen from the arrays via a parallel list
    from shannon_tpu.ops.tipclip import _adjacency_lists

    out_e = np.asarray(ca.out_edges[:, :n_contigs])  # [4, n]
    out_edges = _adjacency_lists(out_e, n_contigs)
    # in-edges: same unique+split with src/dst swapped
    mask = out_e >= 0
    src = np.broadcast_to(
        np.arange(n_contigs, dtype=np.int64), out_e.shape
    )[mask]
    dst = out_e[mask].astype(np.int64)
    if len(dst):
        pairs = np.unique(dst * n_contigs + src)
        counts = np.bincount(pairs // n_contigs, minlength=n_contigs)
        in_edges = [
            seg.tolist()
            for seg in np.split(pairs % n_contigs, np.cumsum(counts)[:-1])
        ]
    else:
        in_edges = [[] for _ in range(n_contigs)]

    rc_pair = [int(x) for x in np.asarray(ca.rc_pair[:n_contigs])]

    g = ContigGraph(
        k=k,
        contigs=contigs,
        out_edges=out_edges,
        in_edges=in_edges,
        rc_pair=rc_pair,
    )
    g._klen = klens.tolist()  # type: ignore[attr-defined]
    if with_kmers:
        g._contig_of_kmer = {
            int(v): (int(c), int(o))
            for v, c, o in zip(vals.tolist(), cids.tolist(), offs.tolist())
        }  # type: ignore[attr-defined]
    return g
