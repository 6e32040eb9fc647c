"""Tip clipping (oracle spec: shannon_tpu/oracle/correction.py step 3)
— remove short dead-end/isolated/bubble contigs dominated at their
attachment junction, then drop their k-mers from the spectrum.

Division of labor (same rationale as ops/partition): the per-k-mer
heavy lifting — condensation into contigs and the final spectrum
compaction — runs on device (sort/probe kernels over millions of
lanes), while the clip-and-re-merge FIXPOINT iteration runs on host at
CONTIG granularity (tens of thousands of nodes), in place of a full
device condensation every round: k-mer-scale rebuilds against
milliseconds of contig-scale host work for the identical result.
Equivalence: removing whole contigs and re-condensing the k-mer graph merges exactly the contig chains the
removal exposes, and the merged contig's abundance equals
float32(sum of member count_sums) / float32(sum of klens) — the
oracle's formula over member k-mers, computed bit-identically from the
exact integer count sums the device emits (ContigArrays.count_sum).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.ops.condense import ContigArrays, build_contig_arrays
from shannon_tpu.ops.correction import _compact
from shannon_tpu.ops.count import Spectrum
from shannon_tpu.ops.kmers import SENTINEL
from shannon_tpu.ops.spectrum import lookup_hilo


@dataclass
class ClipState:
    """Result of the host clip fixpoint: the doom mask over ORIGINAL
    contigs plus the full post-clip merge structure (survivor ->
    member chain in path order, merged klen / count sums, contig
    adjacency) — enough to materialize the post-clip contig graph
    WITHOUT re-condensing the k-mer table.  cycle_merged flags that a
    merge closed a cycle; the contig boundary of a merged cycle is seed-order dependent while a
    device re-condensation breaks cycles at their lexicographically
    smallest k-mer, so callers must fall back to re-condensing then
    (rare: requires a cycle exposed by a clipped attachment)."""

    doomed: np.ndarray  # [n] bool over original contigs
    members: dict[int, list[int]]  # survivor -> original cids, chain order
    kl: dict[int, int]  # survivor -> merged k-mer length
    cs: dict[int, int]  # survivor -> merged count sum
    out: dict[int, list[int]]  # survivor -> surviving successor ids
    cycle_merged: bool


def _adjacency_lists(out_e: np.ndarray, n: int) -> list[list[int]]:
    """[4, n] edge array -> per-contig sorted unique successor lists,
    as one vectorized unique + split, not a per-contig Python set
    loop."""
    mask = out_e >= 0
    src = np.broadcast_to(np.arange(n, dtype=np.int64), out_e.shape)[mask]
    dst = out_e[mask].astype(np.int64)
    if len(src) == 0:
        return [[] for _ in range(n)]
    pairs = np.unique(src * n + dst)
    psrc, pdst = pairs // n, pairs % n
    counts = np.bincount(psrc, minlength=n)
    return [
        seg.tolist()
        for seg in np.split(pdst, np.cumsum(counts)[:-1])
    ]


def _doom_round1(
    klen: np.ndarray,
    csum: np.ndarray,
    out_adj: list[list[int]],
    config,
) -> np.ndarray:
    """Vectorized round-1 doom scan: the exact decision set of
    _doom_check over EVERY contig of the original graph, as numpy
    passes over the edge list (the per-contig Python scan was the
    dominant host cost of the clip rounds at 1M+ contigs).  Returns
    ascending doomed contig ids.  Later (incremental) rounds still use
    the Python decision code — they touch only change neighborhoods.

    Float semantics match _doom_check bit-for-bit: abundances and
    competitor maxima are float32, comparisons are
    float32(c) < rv * comp with comp starting at 0.0."""
    from shannon_tpu.oracle.correction import error_cap

    n = len(klen)
    tip_klen = config.tip_klen_effective
    ratio = np.float32(config.sibling_ratio)
    err_klen = config.error_klen_effective
    err_ratio = np.float32(config.error_branch_ratio)
    er = config.error_rate
    min_len = config.min_transcript_length
    k1 = config.k - 1
    abv = np.float32(csum) / np.float32(klen)
    if err_ratio > 0.0:
        rv = np.where(klen <= err_klen, err_ratio, ratio).astype(np.float32)
    else:
        rv = np.full(n, ratio, np.float32)

    lens = np.fromiter((len(a) for a in out_adj), np.int64, n)
    src = np.repeat(np.arange(n, dtype=np.int64), lens)
    dst = np.fromiter(
        (d for a in out_adj for d in a), np.int64, int(lens.sum())
    )
    outdeg = lens
    indeg = np.bincount(dst, minlength=n)
    short = klen <= tip_klen
    doom = np.zeros(n, bool)

    # isolated contigs
    iso = short & (outdeg == 0) & (indeg == 0)
    doom[iso] = (klen[iso] + k1) < min_len
    if len(src) == 0:
        return np.nonzero(doom)[0]

    def top2(group, other, n):
        """Per-group (max abv[other], its other-id, 2nd max abv) with
        0.0 defaults — 'max excluding x' = max2 when arg1 == x."""
        order = np.lexsort((abv[other], group))
        g, o = group[order], other[order]
        v = abv[o]
        is_last = np.empty(len(g), bool)
        is_last[:-1] = g[1:] != g[:-1]
        is_last[-1] = True
        lasts = np.nonzero(is_last)[0]
        max1 = np.zeros(n, np.float32)
        arg1 = np.full(n, -1, np.int64)
        max2 = np.zeros(n, np.float32)
        max1[g[lasts]] = v[lasts]
        arg1[g[lasts]] = o[lasts]
        prev = lasts - 1
        ok = (prev >= 0) & (g[np.clip(prev, 0, None)] == g[lasts])
        max2[g[lasts[ok]]] = v[prev[ok]]
        return max1, arg1, max2

    # top-2 abundances of each node's PREDECESSORS (grouped by dst)
    # and SUCCESSORS (grouped by src)
    pmax1, parg1, pmax2 = top2(dst, src, n)
    smax1, sarg1, smax2 = top2(src, dst, n)

    # dead-end attached on the right (no in, has out):
    #   comp = max over d in out[c] of (max abv of preds of d except c)
    e_val = np.where(parg1[dst] == src, pmax2[dst], pmax1[dst])
    compR = np.zeros(n, np.float32)
    np.maximum.at(compR, src, e_val.astype(np.float32))
    selR = short & (indeg == 0) & (outdeg > 0)
    doom[selR] = (np.float32(abv[selR]) < rv[selR] * compR[selR]) & (
        abv[selR] <= error_cap(compR[selR], er)
    )

    # dead-end attached on the left (no out, has in):
    #   comp = max over d in inc[c] of (max abv of succs of d except c)
    e_val2 = np.where(sarg1[src] == dst, smax2[src], smax1[src])
    compL = np.zeros(n, np.float32)
    np.maximum.at(compL, dst, e_val2.astype(np.float32))
    selL = short & (outdeg == 0) & (indeg > 0)
    doom[selL] = (np.float32(abv[selL]) < rv[selL] * compL[selL]) & (
        abv[selL] <= error_cap(compL[selL], er)
    )

    # bubble: short, indeg == 1 and outdeg == 1 — competitor is the
    # best x in out[u] ∩ inc[w], x != c, where u/w are the unique
    # pred/succ
    selB = short & (indeg == 1) & (outdeg == 1)
    if selB.any():
        # unique pred of nodes with indeg==1: scatter src by dst
        tmp = np.full(n, -1, np.int64)
        tmp[dst] = src  # any pred; unique when indeg==1
        u = tmp
        tmp2 = np.full(n, -1, np.int64)
        tmp2[src] = dst  # any succ; unique when outdeg==1
        w = tmp2
        # CSR over out-edges (out_adj lists are sorted unique)
        estart = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=estart[1:])
        ekey = src * np.int64(n) + dst  # sorted ascending by construction
        cb = np.nonzero(selB)[0]
        ub, wb = u[cb], w[cb]
        comp = np.zeros(len(cb), np.float32)
        comp_s = np.zeros(len(cb), np.float32)  # error-length competitors
        for t in range(4):
            idx = estart[ub] + t
            valid = t < outdeg[ub]
            x = dst[np.clip(idx, 0, len(dst) - 1)]
            probe = x * np.int64(n) + wb
            pos = np.searchsorted(ekey, probe)
            edge_ok = (pos < len(ekey)) & (
                ekey[np.clip(pos, 0, len(ekey) - 1)] == probe
            )
            ok = valid & (x != cb) & edge_ok
            comp = np.maximum(
                comp, np.where(ok, abv[x], np.float32(0.0))
            ).astype(np.float32)
            # strict competitors: error-comparable length only (the
            # exon-skip-vs-substitution distinction — see _doom_check)
            ok_s = ok & (klen[x] <= err_klen)
            comp_s = np.maximum(
                comp_s, np.where(ok_s, abv[x], np.float32(0.0))
            ).astype(np.float32)
        lax_doom = (np.float32(abv[cb]) < np.float32(ratio) * comp) & (
            abv[cb] <= error_cap(comp, er)
        )
        strict_doom = (
            (err_ratio > 0.0)
            & (klen[cb] <= err_klen)
            & (np.float32(abv[cb]) < err_ratio * comp_s)
            & (abv[cb] <= error_cap(comp_s, er))
        )
        doom[cb] = lax_doom | strict_doom
    return np.nonzero(doom)[0]


def _host_clip_rounds(
    klen: np.ndarray,
    csum: np.ndarray,
    out_adj: list[list[int]],
    config,
) -> ClipState:
    """Iterated contig-level tip clipping: returns the ClipState (doom
    mask over the ORIGINAL contigs + merged survivor structure).
    Mirrors oracle clip_tips exactly: per round, doom short isolated /
    dominated dead-end / popped-bubble contigs (float32 comparisons),
    then merge the chains the removals expose (klen and count sums
    add), repeat to fixpoint or correction_rounds."""
    tip_klen = config.tip_klen_effective
    ratio = np.float32(config.sibling_ratio)
    err_klen = config.error_klen_effective
    err_ratio = np.float32(config.error_branch_ratio)
    min_len = config.min_transcript_length
    n = len(klen)
    members: dict[int, list[int]] = {i: [i] for i in range(n)}
    kl = {i: int(klen[i]) for i in range(n)}
    cs = {i: int(csum[i]) for i in range(n)}
    out: dict[int, list[int]] = {i: list(out_adj[i]) for i in range(n)}
    inc: dict[int, list[int]] = {i: [] for i in range(n)}
    for u, tgts in out.items():
        for v in tgts:
            inc[v].append(u)
    doomed_mask = np.zeros(n, bool)

    # precomputed decision arrays (updated on merge): per-call
    # np.float32 constructions would be the hottest line of the scan
    abv = np.float32(csum) / np.float32(klen)  # float32 abundance
    if err_ratio > 0.0:
        rv = np.where(klen <= err_klen, err_ratio, ratio).astype(np.float32)
    else:
        rv = np.full(n, ratio, np.float32)
    k1 = config.k - 1

    from shannon_tpu.oracle.correction import error_cap

    er = config.error_rate

    def _doom_check(c: int) -> bool:
        """Jacobi doom decision for contig c (pure — reads current
        state, mutates nothing); semantics identical to oracle
        clip_tips round logic."""
        if kl[c] > tip_klen:
            return False
        inc_c, out_c = inc[c], out[c]
        has_in = len(inc_c) > 0
        has_out = len(out_c) > 0
        if not has_in and not has_out:
            return kl[c] + k1 < min_len
        comp = np.float32(0.0)
        if has_in and has_out:
            if len(inc_c) == 1 and len(out_c) == 1:
                # bubble: strict ratio only vs ERROR-comparable-length
                # competitors (an exon-skip junction has the same <= k-1
                # footprint as a substitution bubble but competes with a
                # whole exon — see oracle clip_tips bubble rule); every
                # domination test carries the absolute error cap
                u, w = inc_c[0], out_c[0]
                inc_w = inc[w]
                comp_strict = np.float32(0.0)
                for x in out[u]:
                    if x != c and x in inc_w:
                        if abv[x] > comp:
                            comp = abv[x]
                        if kl[x] <= err_klen and abv[x] > comp_strict:
                            comp_strict = abv[x]
                if abv[c] < ratio * comp and abv[c] <= error_cap(comp, er):
                    return True
                return (
                    err_ratio > 0.0
                    and kl[c] <= err_klen
                    and abv[c] < err_ratio * comp_strict
                    and abv[c] <= error_cap(comp_strict, er)
                )
            return False
        if not has_in:  # attached on the right
            for d in out_c:
                for e in inc[d]:
                    if e != c and abv[e] > comp:
                        comp = abv[e]
        else:  # attached on the left
            for d in inc_c:
                for e in out[d]:
                    if e != c and abv[e] > comp:
                        comp = abv[e]
        return abv[c] < rv[c] * comp and abv[c] <= error_cap(comp, er)

    # Incremental fixpoint: round 1 scans every contig; later rounds
    # scan only contigs within 2 undirected hops of a change (a doom
    # decision reads own attrs, neighbor adjacency, and 2-hop sibling
    # abundances — nothing further).  Merge scans likewise start only
    # where a removal dropped a degree.  Decision code is byte-for-byte
    # the full-scan logic, so the mask is identical (doom rounds are
    # jacobi; removals commute; chain merges are confluent — summed
    # attrs and final topology do not depend on merge order).
    changed: set[int] = set()
    cycle_merged = False
    for rnd in range(config.correction_rounds):
        if rnd == 0:
            cand = out
        else:
            cand_set: set[int] = set()
            for x in changed:
                if x not in out:
                    continue
                cand_set.add(x)
                for y in (*out[x], *inc[x]):
                    cand_set.add(y)
                    cand_set.update(out[y])
                    cand_set.update(inc[y])
            cand = [c for c in cand_set if c in out]
        changed = set()
        if rnd == 0:
            # full-graph scan, vectorized (identical decision set —
            # see _doom_round1); later rounds are neighborhood-sized
            # and stay on the per-contig Python decision code
            doomed = _doom_round1(klen, csum, out_adj, config).tolist()
        else:
            doomed = [c for c in cand if _doom_check(c)]
        if not doomed:
            break
        merge_seeds: set[int] = set()
        for c in doomed:
            doomed_mask[members[c]] = True
            for u in inc[c]:
                if u != c:
                    out[u] = [x for x in out[u] if x != c]
                    changed.add(u)
                    merge_seeds.add(u)
            for w in out[c]:
                if w != c:
                    inc[w] = [x for x in inc[w] if x != c]
                    changed.add(w)
                    merge_seeds.add(w)
                    merge_seeds.update(inc[w])
            del out[c], inc[c], kl[c], cs[c], members[c]
        # merge exposed chains: u -> v with outdeg(u)==1, indeg(v)==1,
        # u != v (repeat at u until it stops absorbing; cycles merge
        # down to a self-loop, matching the oracle's single-contig
        # cycle with self-edge).  A single seeded pass with retry-at-u
        # reaches the same fixpoint as the original repeat-until-stable
        # full scan: merging never changes any other node's degrees, so
        # the mergeable-edge set only ever shrinks, and new
        # opportunities arise only where a removal dropped a degree
        # (merge_seeds) or at the absorber itself.  Round 1 seeds every
        # node to also catch any mergeable edge present in the input.
        if rnd == 0:
            merge_seeds.update(out)
        for u in sorted(merge_seeds):
            while u in out and len(out[u]) == 1:
                v = out[u][0]
                if v == u or v not in inc or len(inc[v]) != 1:
                    if v == u and len(members[u]) > 1:
                        cycle_merged = True  # merge closed a cycle
                    break
                kl[u] += kl[v]
                cs[u] += cs[v]
                members[u].extend(members[v])
                out[u] = [x if x != v else u for x in out[v]]
                for w in out[u]:
                    inc[w] = [x if x != v else u for x in inc[w]]
                del out[v], inc[v], kl[v], cs[v], members[v]
                abv[u] = np.float32(cs[u]) / np.float32(kl[u])
                rv[u] = (
                    err_ratio
                    if err_ratio > 0.0 and kl[u] <= err_klen
                    else ratio
                )
                changed.add(u)
    return ClipState(
        doomed=doomed_mask,
        members=members,
        kl=kl,
        cs=cs,
        out=out,
        cycle_merged=cycle_merged,
    )


@jax.jit
def _drop_contigs(
    spec: Spectrum, ca: ContigArrays, doomed_c: jnp.ndarray
) -> Spectrum:
    """Remove the k-mers of doomed contigs from the spectrum (one
    device program: entry -> contig lookup + compaction sort)."""
    C2 = ca.node_hi.shape[0]
    idx, hit = lookup_hilo(ca.node_hi, ca.node_lo, spec.hi, spec.lo)
    cid_of_entry = jnp.where(hit, ca.node_cid[idx], -1)
    entry_doomed = (cid_of_entry >= 0) & doomed_c[
        jnp.clip(cid_of_entry, 0, C2 - 1)
    ]
    pad = (spec.hi == SENTINEL) & (spec.lo == SENTINEL)
    return _compact(spec, ~entry_doomed & ~pad)


@partial(jax.jit, static_argnames=("out_cap",))
def _device_clip_remap(
    ca: ContigArrays,
    new_cid_d: jnp.ndarray,  # [n_pad] int32 per ORIGINAL contig (-1 doomed)
    off_shift_d: jnp.ndarray,  # [n_pad] int32 per original contig
    hlane_orig: jnp.ndarray,  # [m_pad] int32 OLD node lane of new head
    tlane_orig: jnp.ndarray,  # [m_pad] int32 OLD node lane of new tail
    new_klen: jnp.ndarray,  # [m_pad] int32
    new_csum: jnp.ndarray,  # [m_pad] int32
    rc_new: jnp.ndarray,  # [m_pad] int32
    out_e_new: jnp.ndarray,  # [4, m_pad] int32
    n_new: jnp.ndarray,  # [] int32
    out_cap: int,
) -> ContigArrays:
    """Apply the host-computed clip remap to the pre-clip node table in
    ONE device program: renumber node (cid, offset) to the merged
    contigs, drop doomed nodes, and front-compact the (still sorted)
    table to out_cap lanes via a single position-key sort — the
    condense-lite replacing the full re-condensation (nodes stage +
    8 probes + pointer doubling + reduce sorts) the pipeline used to
    pay a second time."""
    C2 = ca.node_hi.shape[0]
    npad = new_cid_d.shape[0]
    oc = jnp.clip(ca.node_cid, 0, npad - 1)
    nc = jnp.where(ca.node_cid >= 0, new_cid_d[oc], -1)
    keep = nc >= 0
    n_keep = keep.sum(dtype=jnp.int32)
    new_off = jnp.where(keep, ca.node_off + off_shift_d[oc], -1)
    # old lane -> compacted lane (valid at kept lanes)
    new_lane = jnp.cumsum(keep.astype(jnp.int32)) - 1
    hl = jnp.where(
        hlane_orig >= 0, new_lane[jnp.clip(hlane_orig, 0, C2 - 1)], -1
    )
    tl = jnp.where(
        tlane_orig >= 0, new_lane[jnp.clip(tlane_orig, 0, C2 - 1)], -1
    )
    # front-compact kept nodes (dropping preserves (hi, lo) sortedness).
    # Sort only (key, iota) and GATHER the payload arrays through the
    # resulting permutation: a 6-operand sort at the 25M-lane 1M-read
    # table triples the program's transient memory; the permutation
    # form keeps peak footprint to the sort pair plus one gather at a
    # time.
    iota = jax.lax.broadcasted_iota(jnp.uint32, (C2, 1), 0)[:, 0]
    MSB = jnp.uint32(0x80000000)
    skey = jnp.where(keep, iota, iota | MSB)
    _, perm = jax.lax.sort((skey, iota), num_keys=1)
    perm = perm[:out_cap].astype(jnp.int32)
    lidx = jax.lax.broadcasted_iota(jnp.int32, (out_cap, 1), 0)[:, 0]
    nvalid = lidx < n_keep
    node_hi = jnp.where(nvalid, ca.node_hi[perm], SENTINEL)
    node_lo = jnp.where(nvalid, ca.node_lo[perm], SENTINEL)
    node_count = jnp.where(nvalid, ca.node_count[perm], 0)
    node_cid = jnp.where(nvalid, nc[perm], -1)
    node_off = jnp.where(nvalid, new_off[perm], -1)
    return ContigArrays(
        node_hi=node_hi,
        node_lo=node_lo,
        node_count=node_count,
        node_cid=node_cid,
        node_off=node_off,
        klen=new_klen,
        count_sum=new_csum,
        head_lane=hl,
        tail_lane=tl,
        out_edges=out_e_new,
        rc_pair=rc_new,
        n_nodes=n_keep,
        n_contigs=n_new,
    )


def _remap_clipped(
    ca: ContigArrays,
    st: ClipState,
    klen_orig: np.ndarray,
    n2: int,
    k: int,
) -> ContigArrays:
    """Host half of the clip remap: flatten the survivor merge
    structure into per-original-contig (new cid, offset shift) arrays
    and per-new-contig (klen, count sum, head/tail lane, rc twin,
    edges), then run _device_clip_remap.  New contigs are numbered by
    ascending leader original id (leaders are head-rank ordered, so
    numbering stays lexicographic-ish like a fresh condensation)."""
    from shannon_tpu.ops.count import tight_capacity

    n = len(klen_orig)
    survivors = sorted(st.members)
    m = len(survivors)
    sizes = np.fromiter(
        (len(st.members[u]) for u in survivors), np.int64, m
    )
    order = np.fromiter(
        (c for u in survivors for c in st.members[u]),
        np.int64,
        int(sizes.sum()),
    )
    gstarts = np.zeros(m + 1, np.int64)
    np.cumsum(sizes, out=gstarts[1:])
    gidx = np.repeat(np.arange(m, dtype=np.int64), sizes)
    kl_ord = klen_orig[order].astype(np.int64)
    cum_incl = np.cumsum(kl_ord)
    group_before = np.concatenate([[0], cum_incl])[gstarts[:-1]]
    off_in_group = (cum_incl - kl_ord) - group_before[gidx]

    new_cid = np.full(n, -1, np.int32)
    new_cid[order] = gidx
    off_shift = np.zeros(n, np.int32)
    off_shift[order] = off_in_group
    first_member = order[gstarts[:-1]]
    last_member = order[gstarts[1:] - 1]

    m_pad = tight_capacity(m, minimum=1 << 15)
    n_pad = tight_capacity(n, minimum=1 << 15)
    new_cid_p = np.full(n_pad, -1, np.int32)
    new_cid_p[:n] = new_cid
    off_shift_p = np.zeros(n_pad, np.int32)
    off_shift_p[:n] = off_shift

    new_klen = np.zeros(m_pad, np.int32)
    new_klen[:m] = [st.kl[u] for u in survivors]
    new_csum = np.zeros(m_pad, np.int32)
    new_csum[:m] = [st.cs[u] for u in survivors]

    hl_old = np.asarray(ca.head_lane[:n])
    tl_old = np.asarray(ca.tail_lane[:n])
    hlane = np.full(m_pad, -1, np.int32)
    hlane[:m] = hl_old[first_member]
    tlane = np.full(m_pad, -1, np.int32)
    tlane[:m] = tl_old[last_member]

    # rc twin: the new contig beginning with revcomp(new tail k-mer) =
    # the group whose FIRST member is rc_pair[last member]; fall back to
    # self otherwise (mirrors _reduce_stage's rc_is_head check)
    rc_orig = np.asarray(ca.rc_pair[:n]).astype(np.int64)
    rc_new = np.arange(m_pad, dtype=np.int32)
    cand_orig = rc_orig[last_member]
    cand_new = new_cid[cand_orig]
    ok = (cand_new >= 0) & (
        first_member[np.clip(cand_new, 0, max(m - 1, 0))] == cand_orig
    )
    rc_new[:m] = np.where(ok, cand_new, np.arange(m, dtype=np.int32))

    out_e = np.full((4, m_pad), -1, np.int32)
    for i, u in enumerate(survivors):
        for j, v in enumerate(sorted(set(st.out[u]))[:4]):
            out_e[j, i] = new_cid[v]

    # matches what build_contig_arrays(shrunk clipped spectrum) would
    # allocate, so downstream program shapes (threading lookups) are
    # unchanged; capped at the old table size (strand-specific tables
    # are single-orientation: C2 == C)
    out_cap = min(2 * tight_capacity(n2), int(ca.node_hi.shape[0]))
    return _device_clip_remap(
        ca,
        jnp.asarray(new_cid_p),
        jnp.asarray(off_shift_p),
        jnp.asarray(hlane),
        jnp.asarray(tlane),
        jnp.asarray(new_klen),
        jnp.asarray(new_csum),
        jnp.asarray(rc_new),
        jnp.asarray(out_e),
        jnp.int32(m),
        out_cap,
    )


def clip_tips_graph(
    spec: Spectrum, config, canonical: bool = True, notes: dict | None = None
) -> tuple[Spectrum, ContigArrays | None]:
    """Iterated tip clipping to fixpoint, matching oracle clip_tips,
    returning BOTH the clipped spectrum and the post-clip contig graph
    (condense once, not twice — the host clip rounds
    already computed every surviving merged chain, so the pipeline must
    not re-condense the clipped table from scratch).

    Returns (clipped spectrum, ContigArrays or None).  None means the
    caller must build_contig_arrays itself: tip clipping disabled, or
    a host merge closed a cycle (contig boundaries of merged cycles
    are seed-order dependent; a re-condensation breaks them at their
    lexicographically smallest k-mer like the oracle — rare, and
    correctness beats the saved pass).  `notes`, if given, receives
    substage wall times (condense/fetch/rounds/drop/remap) for the
    pipeline's StageTimer."""
    import time as _time

    tip_klen = config.tip_klen_effective
    if tip_klen < 0:
        return spec, None
    t0 = _time.perf_counter()
    ca = build_contig_arrays(spec, config.k, canonical)
    n = int(ca.n_contigs)
    t1 = _time.perf_counter()
    if n == 0:
        return spec, ca
    klen = np.asarray(ca.klen[:n])
    csum = np.asarray(ca.count_sum[:n])
    out_adj = _adjacency_lists(np.asarray(ca.out_edges[:, :n]), n)
    t2 = _time.perf_counter()
    st = _host_clip_rounds(klen, csum, out_adj, config)
    t3 = _time.perf_counter()
    if notes is not None:
        notes.update(
            tc_condense_s=round(t1 - t0, 2),
            tc_fetch_s=round(t2 - t1, 2),
            tc_rounds_s=round(t3 - t2, 2),
            tc_contigs=n,
        )
    if not st.doomed.any():
        return spec, ca
    doomed_pad = np.zeros(ca.node_hi.shape[0], bool)
    doomed_pad[:n] = st.doomed
    out = _drop_contigs(spec, ca, jnp.asarray(doomed_pad))
    t4 = _time.perf_counter()
    if notes is not None:
        notes["tc_drop_s"] = round(t4 - t3, 2)
    if st.cycle_merged:
        return out, None
    ca2 = _remap_clipped(ca, st, klen, int(out.n), config.k)
    if notes is not None:
        notes["tc_remap_s"] = round(_time.perf_counter() - t4, 2)
    return out, ca2


def clip_tips_spectrum(
    spec: Spectrum, config, canonical: bool = True, notes: dict | None = None
) -> Spectrum:
    """Spectrum-only view of clip_tips_graph (kept for callers that
    only need the clipped k-mer table, e.g. parity tests)."""
    out, _ca = clip_tips_graph(spec, config, canonical, notes)
    return out
