"""Mutable assembly graph shared by oracle multibridging and sparse flow
(the per-component structure the reference's run_MB_SF operates on;
SURVEY.md §4.3).

Nodes carry a base string, a k-mer-count-weighted abundance, and
adjacency; reads are symbolic node-id paths threaded once against the
condensed graph and rerouted through node splits (so no re-threading
against mutated sequences is ever needed — splits only refine paths).

Path storage is FLAT ARRAYS (`_flat` node ids + `_offs` row offsets +
`path_weights`), not Python lists: evidence accumulation, dedup,
condensation remapping, and split rerouting are numpy array passes that
scale with unique-path volume at C speed (the MB host loops were the
last read-scale-adjacent Python cost).  `paths`
materializes the list view lazily for callers that want Python lists;
all semantics (dedup order, weight merging) are identical to the
original list implementation (tested).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shannon_tpu.oracle.graph import ContigGraph


@dataclass
class Node:
    seq: str
    abundance: float
    klen: int  # number of member k-mers == len(seq) - k + 1
    out: list[int] = field(default_factory=list)
    inc: list[int] = field(default_factory=list)
    alive: bool = True


def _lists_to_flat(paths: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
    lens = np.fromiter((len(p) for p in paths), np.int64, count=len(paths))
    offs = np.zeros(len(paths) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = np.empty(int(offs[-1]), np.int64)
    for i, p in enumerate(paths):
        flat[offs[i] : offs[i + 1]] = p
    return flat, offs


def _dedup_rows(
    flat: np.ndarray, offs: np.ndarray, weights: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge duplicate paths (sum weights), keeping first-occurrence
    order — vectorized equivalent of the dict-based dedup.

    Dedup runs PER LENGTH CLASS: rows of different length can never be
    equal, most evidence paths are 1-3 nodes, and np.unique(axis=0)
    over one [n, Lmax] padded matrix was 15.4s / ~1GB at 1M reads
    (2.84M paths — the biggest single assembly cost after round 4's
    subgraph vectorization); the same unique over per-length matrices
    touches each element once at its true width.  Semantics are
    byte-identical: uniques from different classes are distinct by
    construction, and the final argsort over original first-occurrence
    indices reproduces the global first-occurrence order exactly."""
    n = len(offs) - 1
    if n == 0:
        return flat[:0], offs[:1], weights[:0]
    lens = np.diff(offs)
    # rows whose l node ids (each < 2^bits) fit one int64 dedup via an
    # EXACT injective bit-pack + 1-D unique — the l <= 3 classes are
    # the bulk of real evidence and 1-D unique is ~10x the void-view
    # row unique
    bits = max(int(flat.max(initial=0)).bit_length(), 1)
    first_l: list[np.ndarray] = []  # original first index per unique
    weight_l: list[np.ndarray] = []
    rowlen_l: list[np.ndarray] = []
    start_l: list[np.ndarray] = []  # original flat start per unique
    for l in np.unique(lens):
        sel = np.nonzero(lens == l)[0]  # ascending = original order
        if l == 0:
            first_l.append(sel[:1])
            weight_l.append(np.array([weights[sel].sum()], np.int64))
            rowlen_l.append(np.zeros(1, np.int64))
            start_l.append(offs[:-1][sel[:1]])
            continue
        src = offs[:-1][sel, None] + np.arange(l, dtype=np.int64)[None, :]
        mat = flat[src]  # [n_l, l]
        if l * bits <= 63:
            key = mat[:, 0].copy()
            for j in range(1, int(l)):
                key = (key << bits) | mat[:, j]
            _, fi, inv = np.unique(
                key, return_index=True, return_inverse=True
            )
        else:
            _, fi, inv = np.unique(
                mat, axis=0, return_index=True, return_inverse=True
            )
        # bincount beats np.add.at ~10x; float64 accumulation is exact
        # for integer weights below 2^53
        ws = np.bincount(
            inv, weights=weights[sel], minlength=len(fi)
        ).astype(np.int64)
        first_l.append(sel[fi])
        weight_l.append(ws)
        rowlen_l.append(np.full(len(fi), l, np.int64))
        start_l.append(offs[:-1][sel[fi]])
    firsts = np.concatenate(first_l)
    wsums = np.concatenate(weight_l)
    klens = np.concatenate(rowlen_l)
    starts = np.concatenate(start_l)
    order = np.argsort(firsts, kind="stable")  # global first-occurrence
    wsums, klens, starts = wsums[order], klens[order], starts[order]
    noffs = np.zeros(len(order) + 1, np.int64)
    np.cumsum(klens, out=noffs[1:])
    src = np.repeat(starts, klens) + (
        np.arange(int(noffs[-1]), dtype=np.int64)
        - np.repeat(noffs[:-1], klens)
    )
    return flat[src], noffs, wsums


class NodeGraph:
    def __init__(
        self,
        k: int,
        nodes: list[Node],
        paths: list[list[int]] | None = None,
        path_weights: list[int] | None = None,
    ):
        self.k = k
        self.nodes = nodes
        self._flat = np.empty(0, np.int64)
        self._offs = np.zeros(1, np.int64)
        self._weights = np.empty(0, np.int64)
        self._list_cache: list[list[int]] | None = None
        # structural-dirty flag: condense() is a no-op on an
        # already-condensed graph, and only degree DROPS (remove_node)
        # can create new mergeable chains — adding edges never does —
        # so clean graphs skip the full-node chain scan (MB/SF call
        # condense every round; most rounds of most component buckets
        # are already clean)
        self._dirty = True
        # structurally-changed node set since the last condense: None =
        # unknown (first condense scans every node); afterwards
        # add_node/add_edge/remove_node record their endpoints and
        # condense re-examines ONLY chains through them — a repeated
        # full-graph Python scan per call costs the whole graph for
        # splits touching a few hundred nodes each round
        self._touched: set[int] | None = None
        self.set_paths(list(paths) if paths else [], path_weights)

    # ---- flat path storage -------------------------------------------
    @property
    def paths(self) -> list[list[int]]:
        """List-of-lists view (lazy, cached until the next set_paths)."""
        if self._list_cache is None:
            offs = self._offs
            fl = self._flat.tolist()
            self._list_cache = [
                fl[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)
            ]
        return self._list_cache

    @paths.setter
    def paths(self, value: list[list[int]]) -> None:
        self.set_paths(list(value) if value is not None else [])

    @property
    def path_weights(self) -> list[int]:
        return self._weights.tolist()

    @path_weights.setter
    def path_weights(self, value) -> None:
        if value is None:
            return
        w = np.asarray(value, np.int64)
        if len(w) != len(self._offs) - 1:
            raise ValueError("weights misaligned with paths")
        self._weights = w

    @property
    def n_paths(self) -> int:
        return len(self._offs) - 1

    def flat_paths(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(flat node ids, row offsets [n+1], weights [n]) — the raw
        storage; callers must not mutate."""
        return self._flat, self._offs, self._weights

    @classmethod
    def from_contig_graph(
        cls,
        g: ContigGraph,
        paths: list[list[int]] | None = None,
        weights: list[int] | None = None,
    ) -> "NodeGraph":
        klens = getattr(g, "_klen", None)
        nodes = [
            Node(
                seq=c.seq,
                abundance=c.abundance,
                klen=(
                    klens[i] if klens is not None else len(c.seq) - g.k + 1
                ),
                out=list(g.out_edges[i]),
                inc=list(g.in_edges[i]),
            )
            for i, c in enumerate(g.contigs)
        ]
        return cls(k=g.k, nodes=nodes, paths=paths or [], path_weights=weights)

    def set_paths(
        self, paths: list[list[int]], weights: list[int] | None = None
    ) -> None:
        """Replace the evidence paths, merging duplicates into weights.
        First-occurrence order is kept, so downstream iteration order
        (edge insertion, evidence accumulation) matches the un-deduped
        per-read sequence exactly."""
        if weights is None:
            w = np.ones(len(paths), np.int64)
        else:
            w = np.asarray(weights, np.int64)
        flat, offs = _lists_to_flat(paths)
        self.set_paths_flat(flat, offs, w)

    def set_paths_flat(
        self, flat: np.ndarray, offs: np.ndarray, weights: np.ndarray
    ) -> None:
        self._flat, self._offs, self._weights = _dedup_rows(
            np.asarray(flat, np.int64),
            np.asarray(offs, np.int64),
            np.asarray(weights, np.int64),
        )
        self._list_cache = None

    def path_weight_list(self) -> list[int]:
        """Weights aligned with self.paths."""
        return self._weights.tolist()

    # ------------------------------------------------------------------
    def add_node(self, seq: str, abundance: float, klen: int) -> int:
        self.nodes.append(Node(seq=seq, abundance=abundance, klen=klen))
        nid = len(self.nodes) - 1
        if self._touched is not None:
            self._touched.add(nid)
        return nid

    def add_edge(self, u: int, v: int) -> None:
        if v not in self.nodes[u].out:
            self.nodes[u].out.append(v)
        if u not in self.nodes[v].inc:
            self.nodes[v].inc.append(u)
        if self._touched is not None:
            self._touched.add(u)
            self._touched.add(v)

    def remove_node(self, v: int) -> None:
        self._dirty = True
        nv = self.nodes[v]
        if self._touched is not None:
            self._touched.add(v)
            self._touched.update(nv.inc)
            self._touched.update(nv.out)
        for u in nv.inc:
            if u != v:
                self.nodes[u].out = [x for x in self.nodes[u].out if x != v]
        for w in nv.out:
            if w != v:
                self.nodes[w].inc = [x for x in self.nodes[w].inc if x != v]
        nv.out, nv.inc, nv.alive = [], [], False

    def x_nodes(self) -> list[int]:
        """Unresolved repeat nodes: indeg > 1 and outdeg > 1 (SURVEY.md
        §4.3 'X-node')."""
        return [
            i
            for i, n in enumerate(self.nodes)
            if n.alive and len(n.inc) > 1 and len(n.out) > 1
        ]

    # ------------------------------------------------------------------
    def condense(self) -> None:
        """Merge every chain u -> v with outdeg(u)==1, indeg(v)==1,
        u != v, concatenating sequences with the (k-1)-overlap dropped and
        k-mer-count-weighting abundances.  Read paths are remapped
        (vectorized).  Deterministic: chains are walked from their
        lowest-id head.

        Incremental: after the first (full-scan) condense, only chains
        through nodes recorded in self._touched are re-examined — a new
        mergeable link can only appear at a node whose structure changed
        (tracked by add_node/add_edge/remove_node), and the first walk
        from any touched node claims its whole maximal chain, so chains
        stay maximal and disjoint."""
        if not self._dirty:
            return
        touched = self._touched
        self._dirty = False
        self._touched = set()
        if touched is not None:
            self._condense_touched(touched)
            return
        n0 = len(self.nodes)

        def mergeable(u: int, v: int) -> bool:
            return (
                u != v
                and len(self.nodes[u].out) == 1
                and len(self.nodes[v].inc) == 1
            )

        head_of: dict[int, int] = {}
        chains: list[list[int]] = []
        # heads: alive nodes whose unique predecessor (if any) is not
        # merge-linked to them
        for v in range(n0):
            if not self.nodes[v].alive:
                continue
            inc = self.nodes[v].inc
            if len(inc) == 1 and mergeable(inc[0], v):
                continue
            chain = [v]
            x = v
            while True:
                out = self.nodes[x].out
                if len(out) != 1:
                    break
                y = out[0]
                if not mergeable(x, y) or y in head_of or y == chain[0]:
                    break
                chain.append(y)
                head_of[y] = v
                x = y
            head_of[v] = v
            chains.append(chain)
        # isolated cycles where every link is mergeable: every node has a
        # merge-linked predecessor, so none was picked as head; walk from
        # the lowest id.
        for v in range(n0):
            if self.nodes[v].alive and v not in head_of:
                chain = [v]
                head_of[v] = v
                x = v
                while True:
                    y = self.nodes[x].out[0]
                    if y in head_of:
                        break
                    chain.append(y)
                    head_of[y] = v
                    x = y
                chains.append(chain)

        k1 = self.k - 1
        remap_arr = np.arange(n0, dtype=np.int64)
        changed = False
        for chain in chains:
            h = chain[0]
            if len(chain) > 1:
                changed = True
                seq = self.nodes[h].seq + "".join(
                    self.nodes[x].seq[k1:] for x in chain[1:]
                )
                wsum = sum(self.nodes[x].abundance * self.nodes[x].klen for x in chain)
                klen = sum(self.nodes[x].klen for x in chain)
                tail = chain[-1]
                new_out = list(self.nodes[tail].out)
                nh = self.nodes[h]
                nh.seq, nh.abundance, nh.klen = seq, wsum / klen, klen
                nh.out = new_out
                for x in chain[1:]:
                    self.nodes[x].alive = False
                    self.nodes[x].out, self.nodes[x].inc = [], []
                    remap_arr[x] = h
        # rebuild inc/out with remapped ids
        for v in range(len(self.nodes)):
            nv = self.nodes[v]
            if nv.alive:
                nv.out = sorted({int(remap_arr[w]) if w < n0 else w for w in nv.out})
        for v in range(len(self.nodes)):
            self.nodes[v].inc = []
        for v in range(len(self.nodes)):
            for w in self.nodes[v].out:
                self.nodes[w].inc.append(v)
        for v in range(len(self.nodes)):
            self.nodes[v].inc.sort()
        if not changed:
            return  # nothing merged: paths (already deduped) untouched
        # remap read paths (vectorized), collapsing consecutive
        # duplicates; paths made equal by the remap merge their weights
        flat, offs, weights = self._flat, self._offs, self._weights
        if len(flat):
            nf = remap_arr[flat]
            lens = np.diff(offs)
            is_start = np.zeros(len(nf), bool)
            is_start[offs[:-1][lens > 0]] = True
            keep = is_start.copy()
            keep[1:] |= nf[1:] != nf[:-1]
            row_of = np.repeat(np.arange(len(offs) - 1), lens)
            kept_rows = row_of[keep]
            noffs = np.zeros(len(offs), np.int64)
            np.cumsum(np.bincount(kept_rows, minlength=len(offs) - 1), out=noffs[1:])
            self.set_paths_flat(nf[keep], noffs, weights)

    def _condense_touched(self, touched: set[int]) -> None:
        """Incremental condense: examine only chains through `touched`
        nodes.  Semantics identical to the full scan (same chain heads,
        same merged attributes, same path remap); only the portion of
        the graph that could have gained a mergeable link is walked."""
        nodes = self.nodes
        n_all = len(nodes)

        def mergeable(u: int, v: int) -> bool:
            return (
                u != v
                and len(nodes[u].out) == 1
                and len(nodes[v].inc) == 1
            )

        head_of: dict[int, int] = {}
        chains: list[list[int]] = []
        for t in sorted(touched):
            if t >= n_all or not nodes[t].alive or t in head_of:
                continue
            # walk back to the chain head (or detect an isolated
            # all-mergeable cycle: head = lowest id, as in the full scan)
            h = t
            seen = {t}
            while True:
                inc = nodes[h].inc
                if len(inc) != 1 or not mergeable(inc[0], h):
                    break
                u = inc[0]
                if u in seen:
                    h = min(seen)
                    break
                seen.add(u)
                h = u
            if h in head_of:
                continue
            chain = [h]
            head_of[h] = h
            x = h
            while True:
                out = nodes[x].out
                if len(out) != 1:
                    break
                y = out[0]
                if not mergeable(x, y) or y in head_of or y == chain[0]:
                    break
                chain.append(y)
                head_of[y] = h
                x = y
            if len(chain) > 1:
                chains.append(chain)
        if not chains:
            return

        k1 = self.k - 1
        # member -> head map (only head ids are externally visible as
        # edge targets: interior members have indeg 1 from their chain
        # predecessor, so no external edge can point at them)
        remap: dict[int, int] = {}
        for chain in chains:
            for x in chain[1:]:
                remap[x] = chain[0]
        for chain in chains:
            h = chain[0]
            tail = chain[-1]
            seq = nodes[h].seq + "".join(nodes[x].seq[k1:] for x in chain[1:])
            wsum = sum(nodes[x].abundance * nodes[x].klen for x in chain)
            klen = sum(nodes[x].klen for x in chain)
            new_out = sorted({remap.get(x, x) for x in nodes[tail].out})
            nh = nodes[h]
            nh.seq, nh.abundance, nh.klen = seq, wsum / klen, klen
            nh.out = new_out
            for x in chain[1:]:
                nodes[x].alive = False
                nodes[x].out, nodes[x].inc = [], []
            for w in new_out:
                nodes[w].inc = sorted(
                    {remap.get(x, x) for x in nodes[w].inc}
                )

        # remap read paths through the merged members (vectorized),
        # collapsing consecutive duplicates — same as the full scan
        flat, offs, weights = self._flat, self._offs, self._weights
        if len(flat):
            remap_arr = np.arange(n_all, dtype=np.int64)
            for x, h in remap.items():
                remap_arr[x] = h
            nf = remap_arr[flat]
            lens = np.diff(offs)
            is_start = np.zeros(len(nf), bool)
            is_start[offs[:-1][lens > 0]] = True
            keep = is_start.copy()
            keep[1:] |= nf[1:] != nf[:-1]
            row_of = np.repeat(np.arange(len(offs) - 1), lens)
            kept_rows = row_of[keep]
            noffs = np.zeros(len(offs), np.int64)
            np.cumsum(
                np.bincount(kept_rows, minlength=len(offs) - 1),
                out=noffs[1:],
            )
            self.set_paths_flat(nf[keep], noffs, weights)

    # ------------------------------------------------------------------
    def alive_ids(self) -> list[int]:
        return [i for i, n in enumerate(self.nodes) if n.alive]

    def components(self) -> list[list[int]]:
        """Weakly-connected components over alive nodes."""
        ids = self.alive_ids()
        parent = {i: i for i in ids}

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for u in ids:
            for v in self.nodes[u].out:
                ra, rb = find(u), find(v)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
        groups: dict[int, list[int]] = {}
        for u in ids:
            groups.setdefault(find(u), []).append(u)
        return [groups[r] for r in sorted(groups)]
