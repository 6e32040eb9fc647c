"""Oracle multibridging — read threading + repeat-node resolution
(reference stage 4 MB; SURVEY.md §3.1 'Multibridging', §4.3).

Spec (binding for the device pipeline):

  * **Threading**: each read is mapped to a node path once, on the
    condensed graph: walk the read's k-mers (as-is orientation; in
    canonical mode the RC copy of the path is implied by graph symmetry
    and is added explicitly so both orientation copies receive identical
    evidence), look each up in the k-mer -> (contig, offset) map, take the
    longest consecutive run of found k-mers with *consistent geometry*
    (same contig with advancing offset, or a contig-graph edge at a
    contig boundary), and record the sequence of distinct contigs
    visited.  Reads whose k-mers are all absent (fully corrected away)
    contribute no path.

  * **Evidence**: every consecutive triple (a, v, b) in a read path is
    one unit of bridging evidence for pairing in-edge (a,v) with
    out-edge (v,b) at v.  Paired-end mates whose paths connect through an
    edge contribute a joined path (mate path reverse-complemented into
    the read's orientation), extending evidence across gaps shorter than
    one node — the 'long context' mechanism (SURVEY.md §6).

  * **Resolution** (iterated with condensation until fixpoint): an X-node
    v (indeg>1, outdeg>1) is *fully bridged* when every in-neighbor and
    every out-neighbor of v appears in at least one evidence pair at v.
    A fully bridged v splits into one copy per distinct evidence pair
    (u, w): copy v_{u,w} has edges u -> v_{u,w} -> w, sequence = v's,
    abundance = abund(v) * evidence(u,w) / total_evidence(v).  Read
    paths through v are rerouted to the matching copy; reads that start
    (resp. end) at v reroute to the unique copy consistent with their
    next (resp. previous) node if unique, otherwise their path is
    truncated at v (ambiguous continuation carries no evidence).
    All fully bridged X-nodes split in the same round (jacobi-style,
    order-independent -> reproducible on device).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.oracle.counting import _seq_kmers
from shannon_tpu.oracle.graph import ContigGraph
from shannon_tpu.oracle.nodegraph import NodeGraph

import numpy as np


class Run(NamedTuple):
    """One consistent threading run of a read: the contig path plus the
    geometry anchors that make insert-size reasoning possible —
    (p0, p1) = read window index of the run's first/last hit window,
    (o0, o1) = contig k-mer offset of those two windows (o0 within
    path[0], o1 within path[-1])."""

    path: list[int]
    p0: int
    p1: int
    o0: int
    o1: int

    @property
    def windows(self) -> int:
        return self.p1 - self.p0 + 1


def thread_read_runs(
    codes: np.ndarray,
    k: int,
    contig_of_kmer: dict[int, tuple[int, int]],
    graph: ContigGraph,
) -> list[Run]:
    """Map one read to its consistent runs (in read order).

    A run is a maximal stretch of consecutive windows whose k-mers are
    alive.  Note: consecutive alive windows are automatically
    geometrically consistent (an alive k-mer's in-contig successor is
    its unique graph successor), so no adjacency re-checks are needed —
    the device threading kernel relies on the same fact.
    """
    kmers = _seq_kmers(codes, k)
    if len(kmers) == 0:
        return []
    hits = [contig_of_kmer.get(int(v)) for v in kmers]

    runs: list[Run] = []
    cur: list[int] = []
    cur_p0 = cur_o0 = 0
    prev: tuple[int, int] | None = None

    def flush(p1: int, o1: int) -> None:
        nonlocal cur
        if cur:
            runs.append(Run(path=cur, p0=cur_p0, p1=p1, o0=cur_o0, o1=o1))
        cur = []

    last_pos_off = (0, 0)
    for j, h in enumerate(hits):
        if h is None:
            flush(*last_pos_off)
            prev = None
            continue
        cid, off = h
        if prev is None:
            cur = [cid]
            cur_p0, cur_o0 = j, off
        elif off == 0:
            cur.append(cid)  # crossing a contig boundary
        prev = (cid, off)
        last_pos_off = (j, off)
    flush(*last_pos_off)
    return runs


def thread_read(
    codes: np.ndarray,
    k: int,
    contig_of_kmer: dict[int, tuple[int, int]],
    graph: ContigGraph,
) -> list[int]:
    """Longest-run contig path (ties -> earliest run); the
    rescue_reads=False threading mode."""
    runs = thread_read_runs(codes, k, contig_of_kmer, graph)
    best: list[int] = []
    best_w = 0
    for r in runs:
        if r.windows > best_w:
            best, best_w = r.path, r.windows
    return best


def _klen_of(graph: ContigGraph, cid: int) -> int:
    """#member k-mers of a contig (transcript distance it contributes)."""
    kl = getattr(graph, "_klen", None)
    if kl is not None:
        return kl[cid]
    return len(graph.contigs[cid].seq) - graph.k + 1


class InsertStats(NamedTuple):
    mean: float
    sigma: float


def estimate_insert_stats(
    pairs: list[tuple[Run, Run, int, int]],
    graph: ContigGraph,
    config: AssemblyConfig,
) -> InsertStats | None:
    """Insert-size distribution: configured (config.insert_size > 0) or
    estimated from pairs whose facing anchor windows land in the SAME
    contig (fragment length is then exact: o2 - o1 + p1 - p2 + r2).
    Estimator: weighted median + 1.4826*MAD (robust to mis-joins).
    None when neither is available (joining then falls back to the
    uncapped direct-edge rule)."""
    if config.insert_size > 0:
        sigma = (
            float(config.insert_size_std)
            if config.insert_size_std > 0
            else 0.1 * config.insert_size
        )
        return InsertStats(float(config.insert_size), sigma)
    frags: list[int] = []
    weights: list[int] = []
    for rl, rr, r2, w in pairs:
        if rl.path[-1] != rr.path[0]:
            continue
        frag = (rr.o0 - rl.o1) + rl.p1 - rr.p0 + r2
        if frag >= r2:  # mates in order; junk anchors excluded
            frags.append(frag)
            weights.append(w)
    if sum(weights) < 8:
        return None
    order = np.argsort(frags, kind="stable")
    fa = np.asarray(frags, dtype=np.float64)[order]
    wa = np.asarray(weights, dtype=np.float64)[order]
    cw = np.cumsum(wa)
    med = float(fa[np.searchsorted(cw, 0.5 * cw[-1])])
    dev = np.abs(fa - med)
    dorder = np.argsort(dev, kind="stable")
    cwd = np.cumsum(wa[dorder])
    mad = float(dev[dorder][np.searchsorted(cwd, 0.5 * cwd[-1])])
    sigma = max(1.4826 * mad, 0.05 * med, 1.0)
    return InsertStats(med, sigma)


def join_pair_runs(
    rl: Run,
    rr: Run,
    r2: int,
    graph: ContigGraph,
    config: AssemblyConfig,
    stats: InsertStats | None,
) -> list[int] | None:
    """Join the facing runs of a mate pair (both already in transcript
    orientation — mate 2 is reverse-complemented at ingest).

    1. Largest contig-level overlap (suffix of pl == prefix of pr):
       direct shared evidence, always accepted.
    2. Gap join through <= config.pair_gap_nodes intermediate contigs:
       the implied fragment length
           frag = (klen(pl[-1]) - o1) + sum klen(gap) + o2 + p1 - p2 + r2
       must fit the insert distribution — a direct-edge join (0
       intermediates) is rejected above mean + s*sigma, a multi-node
       join (asserting unseen sequence) must land inside
       [mean - s*sigma, mean + s*sigma].  Among feasible gap paths the
       fragment closest to the mean wins; two DIFFERENT gaps at the
       same distance are ambiguous evidence -> no join.  Without
       insert stats only the direct-edge join is attempted (uncapped
       legacy rule).
    None if the paths neither overlap nor admit a feasible gap join.
    Reference contract: SURVEY.md §3.1 'Multibridging' (paired-end
    mates, with insert-size constraints, bridge longer repeats) and §6
    'long context'."""
    pl, pr = rl.path, rr.path
    if not pl or not pr:
        return None
    for t in range(len(pl)):
        m = len(pl) - t
        if m <= len(pr) and pl[t:] == pr[:m]:
            return pl + pr[m:]
        if m > len(pr) and pl[t : t + len(pr)] == pr:
            return pl  # mate 2 entirely inside mate 1's path
    c1, c2 = pl[-1], pr[0]
    if stats is None:
        if c2 in graph.out_edges[c1]:
            return pl + pr
        return None
    s = config.insert_cap_sigmas
    lo, hi = stats.mean - s * stats.sigma, stats.mean + s * stats.sigma
    base = _klen_of(graph, c1) - rl.o1 + rr.o0 + rl.p1 - rr.p0 + r2
    # bounded DFS over simple gap paths c1 -> g_1..g_m -> c2
    best: tuple[float, tuple[int, ...]] | None = None
    tied = False
    stack: list[tuple[int, tuple[int, ...], int]] = [(c1, (), 0)]
    while stack:
        u, gap, glen = stack.pop()
        for v in graph.out_edges[u]:
            if v == c2:
                frag = base + glen
                if frag <= hi and (len(gap) == 0 or frag >= lo):
                    key = (abs(frag - stats.mean), gap)
                    if best is None or key[0] < best[0]:
                        best, tied = key, False
                    elif key[0] == best[0] and gap != best[1]:
                        tied = True  # distinct gaps, equal geometry
            if (
                len(gap) < config.pair_gap_nodes
                and v != c1
                and v != c2
                and v not in gap
            ):
                nglen = glen + _klen_of(graph, v)
                if base + nglen <= hi:  # prune: fragment only grows
                    stack.append((v, gap + (v,), nglen))
    if best is None or tied:
        return None
    return pl + list(best[1]) + pr


def expand_paths(
    raw_runs: list[list[Run]],
    graph: ContigGraph,
    config: AssemblyConfig,
    paired: bool = False,
    weights: list[int] | None = None,
    read_lengths: list[int] | None = None,
) -> tuple[list[list[int]], list[int]]:
    """Per-read Run lists (aligned with reads; [] = unthreadable) ->
    (evidence path list, per-path multiplicities):

      * every run is evidence (read rescue);
      * for pairs, the facing ends (last run of mate 1, first run of
        mate 2 — both already transcript-oriented) are joined under the
        insert-size constraint (join_pair_runs), bridging repeats
        longer than a read; the insert distribution comes from config
        or is estimated from same-contig pairs (estimate_insert_stats);
      * in canonical mode each path's RC twin is added so both
        orientation copies of the graph receive identical evidence;
      * `weights` (aligned with raw_runs; mates of a deduped pair carry
        equal weight) lets callers pass pre-deduplicated rows — every
        emitted path inherits its source read's multiplicity;
      * `read_lengths` (aligned with raw_runs) feeds fragment-length
        computation; without it pair joining falls back to the
        uncapped direct-edge rule.

    Shared by the oracle and device threading backends."""
    out: list[list[int]] = []
    out_w: list[int] = []
    if weights is None:
        weights = [1] * len(raw_runs)

    def emit(p: list[int], w: int) -> None:
        if not p:
            return
        out.append(p)
        out_w.append(w)
        if not config.strand_specific:
            out.append([graph.rc_pair[c] for c in reversed(p)])
            out_w.append(w)

    def emit_all(runs: list[Run], w: int) -> None:
        for r in runs:
            emit(r.path, w)

    if paired and config.use_pairs:
        facing: list[tuple[Run, Run, int, int]] = []
        for i in range(0, len(raw_runs) - 1, 2):
            rl, rr = raw_runs[i], raw_runs[i + 1]
            if rl and rr and read_lengths is not None:
                facing.append(
                    (rl[-1], rr[0], read_lengths[i + 1], weights[i])
                )
        stats = (
            estimate_insert_stats(facing, graph, config)
            if read_lengths is not None
            else None
        )
        for i in range(0, len(raw_runs) - 1, 2):
            rl, rr = raw_runs[i], raw_runs[i + 1]
            w = weights[i]
            joined = None
            if rl and rr:
                r2 = read_lengths[i + 1] if read_lengths is not None else 0
                joined = join_pair_runs(
                    rl[-1], rr[0], r2, graph, config, stats
                )
            if joined is not None:
                emit_all(rl[:-1], w)
                emit(joined, w)
                emit_all(rr[1:], w)
            else:
                emit_all(rl, w)
                emit_all(rr, w)
        if len(raw_runs) % 2:
            emit_all(raw_runs[-1], weights[-1])
    else:
        for runs, w in zip(raw_runs, weights):
            emit_all(runs, w)
    return out, out_w


def thread_reads(
    read_codes: list[np.ndarray],
    graph: ContigGraph,
    config: AssemblyConfig,
    paired: bool = False,
) -> tuple[list[list[int]], list[int]]:
    """Thread every read and expand to evidence (paths, weights)
    (rescue + pair joining + RC twins per expand_paths)."""
    contig_of_kmer = graph._contig_of_kmer  # type: ignore[attr-defined]
    raw: list[list[Run]] = []
    for codes in read_codes:
        runs = thread_read_runs(codes, config.k, contig_of_kmer, graph)
        if not config.rescue_reads:
            best: Run | None = None
            for r in runs:
                if best is None or r.windows > best.windows:
                    best = r
            raw.append([best] if best is not None else [])
        else:
            raw.append(runs)
    return expand_paths(
        raw, graph, config, paired,
        read_lengths=[len(c) for c in read_codes],
    )


def filter_noise_pairs(
    pairs: Counter | None, config: AssemblyConfig
) -> Counter | None:
    """Evidence pairs above the noise floor: weight >= max(floor, T/8)
    when total T >= 2*floor (see config.mb_noise_floor); small totals
    keep everything.  Shared by MB resolution and SF's evidence
    union."""
    if not pairs:
        return pairs
    nf = config.mb_noise_floor
    total_ev = sum(pairs.values())
    if nf > 0 and total_ev >= 2 * nf:
        floor = max(nf, total_ev / 8.0)
        return Counter({p: w for p, w in pairs.items() if w >= floor})
    return pairs


def _evidence_at(g: NodeGraph) -> dict[int, Counter]:
    """Bridging evidence per node: ev[v][(a, b)] = total weight of path
    triples (a, v, b).  Vectorized over the flat path arrays — one
    numpy pass + a loop over UNIQUE triples (graph-complexity-bound,
    not path-volume-bound)."""
    flat, offs, weights = g.flat_paths()
    ev: dict[int, Counter] = {}
    if len(flat) == 0:
        return ev
    lens = np.diff(offs)
    row_of = np.repeat(np.arange(len(lens)), lens)
    pos_in = np.arange(len(flat)) - np.repeat(offs[:-1], lens)
    interior = (pos_in >= 1) & (pos_in < np.repeat(lens, lens) - 1)
    idx = np.nonzero(interior)[0]
    if len(idx) == 0:
        return ev
    trip = np.stack([flat[idx], flat[idx - 1], flat[idx + 1]], axis=1)
    uniq, inv = np.unique(trip, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, weights[row_of[idx]])
    for (v, a, b), s in zip(uniq.tolist(), sums.tolist()):
        ev.setdefault(v, Counter())[(a, b)] = s
    return ev


def _affected_rows(g: NodeGraph, split_ids) -> tuple[np.ndarray, np.ndarray]:
    """Row indices of paths touching any split node, and the boolean
    per-position hit mask's row map — the reroute loop then runs ONLY
    over affected paths (most paths pass every round untouched)."""
    flat, offs, _ = g.flat_paths()
    lens = np.diff(offs)
    row_of = np.repeat(np.arange(len(lens)), lens)
    hit = np.isin(flat, np.fromiter(split_ids, np.int64, len(split_ids)))
    return np.unique(row_of[hit]), row_of


def _reroute_paths(
    g: NodeGraph,
    split_map: dict[int, dict[tuple[int, int], int]],
    drop_on_interior_miss: bool,
) -> None:
    """Reroute evidence paths through node splits (shared by MB and SF;
    they differ on interior misses — MB drops the whole path, SF keeps
    the prefix).  Unaffected paths are carried over as array slices;
    the Python loop runs only over paths containing a split node.
    Output path order is original-unaffected-first then rerouted —
    order is immaterial downstream (adjacency is re-sorted by the next
    condense(); evidence, enumeration, and dedup are order-insensitive)
    and deterministic."""
    flat, offs, weights = g.flat_paths()
    n_rows = len(offs) - 1
    if n_rows == 0 or not split_map:
        return
    aff, row_of = _affected_rows(g, split_map.keys())
    if len(aff) == 0:
        return
    aff_set = np.zeros(n_rows, bool)
    aff_set[aff] = True
    keep_pos = ~aff_set[row_of]
    lens = np.diff(offs)
    base_flat = flat[keep_pos]
    base_lens = lens[~aff_set]
    base_w = weights[~aff_set]

    paths = g.paths  # materialized once; we index only affected rows
    wlist = weights
    new_lists: list[list[int]] = []
    new_w: list[int] = []
    for ri in aff.tolist():
        p = paths[ri]
        q: list[int] = []
        ok = True
        for i, x in enumerate(p):
            copies = split_map.get(x)
            if copies is None:
                q.append(x)
                continue
            a = p[i - 1] if i > 0 else None
            b = p[i + 1] if i + 1 < len(p) else None
            nid = copies.get((a, b)) if a is not None and b is not None else None
            if nid is None:
                if a is not None and b is not None:
                    if drop_on_interior_miss:
                        ok = False
                    break
                if a is None and b is not None:
                    cands = sorted(
                        {n for (pa, pb), n in copies.items() if pb == b}
                    )
                elif b is None and a is not None:
                    cands = sorted(
                        {n for (pa, pb), n in copies.items() if pa == a}
                    )
                else:  # single-node path
                    cands = []
                if len(cands) == 1:
                    q.append(cands[0])
                    continue
                break  # truncate (ambiguous)
            q.append(nid)
        if ok and q:
            new_lists.append(q)
            new_w.append(int(wlist[ri]))

    add_flat, add_offs = (
        (np.empty(0, np.int64), np.zeros(1, np.int64))
        if not new_lists
        else (None, None)
    )
    if new_lists:
        total = sum(len(q) for q in new_lists)
        add_flat = np.empty(total, np.int64)
        add_lens = np.empty(len(new_lists), np.int64)
        pos = 0
        for i, q in enumerate(new_lists):
            add_flat[pos : pos + len(q)] = q
            add_lens[i] = len(q)
            pos += len(q)
    else:
        add_lens = np.empty(0, np.int64)
    out_lens = np.concatenate([base_lens, add_lens])
    out_offs = np.zeros(len(out_lens) + 1, np.int64)
    np.cumsum(out_lens, out=out_offs[1:])
    g.set_paths_flat(
        np.concatenate([base_flat, add_flat]),
        out_offs,
        np.concatenate([base_w, np.asarray(new_w, np.int64)]),
    )


def multibridge(g: NodeGraph, config: AssemblyConfig, max_rounds: int = 16) -> int:
    """Run MB resolution rounds in place; returns number of nodes split."""
    total_split = 0
    for _ in range(max_rounds):
        g.condense()
        ev = _evidence_at(g)
        targets: list[tuple[int, Counter]] = []
        for v in g.x_nodes():
            # noise floor (config.mb_noise_floor): error reads thread
            # into surviving error branches and deposit low-weight cross
            # pairings; counting them splits the node per spurious pair
            # and deletes the true continuation.  Dropping them either
            # leaves the node unsplit (all paths stay enumerable) or
            # splits on real pairings only.
            pairs = filter_noise_pairs(ev.get(v), config)
            if not pairs:
                continue
            ins = {a for (a, _b) in pairs}
            outs = {b for (_a, b) in pairs}
            if ins == set(g.nodes[v].inc) and outs == set(g.nodes[v].out):
                targets.append((v, pairs))
        if not targets:
            break
        split_map: dict[int, dict[tuple[int, int], int]] = {}
        for v, pairs in targets:
            node = g.nodes[v]
            total_ev = sum(pairs.values())
            copies: dict[tuple[int, int], int] = {}
            for (a, b), cnt in sorted(pairs.items()):
                nid = g.add_node(
                    node.seq, node.abundance * cnt / total_ev, node.klen
                )
                copies[(a, b)] = nid
            split_map[v] = copies
        # wire copies; neighbor endpoints may themselves be split nodes —
        # but a neighbor of an X-node has (indeg<=1 or outdeg<=1) only if
        # it is not itself fully-bridged-X; two adjacent split X-nodes are
        # handled by path rerouting below plus edge wiring via paths.
        for v, copies in split_map.items():
            for (a, b), nid in copies.items():
                if a not in split_map:
                    g.add_edge(a, nid)
                if b not in split_map:
                    g.add_edge(nid, b)
        # reroute read paths (evidence keys use pre-split neighbor ids,
        # so neighbors that are themselves splitting match by original
        # id) and wire split-split adjacencies from the rerouted paths
        _reroute_paths(g, split_map, drop_on_interior_miss=True)
        _wire_path_edges(g)
        # retire the split originals
        for v in split_map:
            g.remove_node(v)
        total_split += len(split_map)
    g.condense()
    return total_split


def _wire_path_edges(g: NodeGraph) -> None:
    """add_edge for every consecutive pair in every path (covers the
    adjacent-split-node case) — one numpy pass to the UNIQUE pairs."""
    flat, offs, _ = g.flat_paths()
    if len(flat) == 0:
        return
    lens = np.diff(offs)
    pos_in = np.arange(len(flat)) - np.repeat(offs[:-1], lens)
    has_next = pos_in < np.repeat(lens, lens) - 1
    idx = np.nonzero(has_next)[0]
    if len(idx) == 0:
        return
    pairs = np.unique(np.stack([flat[idx], flat[idx + 1]], axis=1), axis=0)
    for u, v in pairs.tolist():
        g.add_edge(u, v)
