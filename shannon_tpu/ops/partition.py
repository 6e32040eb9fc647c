"""Graph partitioning — the GPMETIS replacement (SURVEY.md §3.2 row 2):
weakly-connected components of the contig graph from the
device-emitted edge arrays.

The reference cuts the contig graph into ~equal pieces with METIS so a
process pool can chew them in parallel; independent assembly is only
*sound* per weakly-connected component, so the rebuild partitions into
exact components and treats load balance as a scheduling concern:
`bucket_components` groups components into padded size classes for
batched processing (SURVEY.md §3.3).

Why this is a host pass over device arrays, not a device kernel: a
min-label-propagation + pointer-jumping kernel's per-round edge
relaxation is a scatter-min over 4x the node lanes, and its round count
is diameter-dependent (a bounded-round version mis-labeled a ~1M-contig
graph).  Connected components is irreducibly pointer-chasing; the
division of labor is: the graph
(edges, degrees) is BUILT on device by sort/probe kernels
(ops/condense), and the one pointer-chasing reduction runs as a C-speed
sparse pass on host (scipy.sparse.csgraph, O(E)) over those arrays —
the same split the pipeline uses for contig-string materialization.
"""

from __future__ import annotations

import numpy as np

from shannon_tpu.ops.condense import ContigArrays


def connected_components(ca: ContigArrays) -> np.ndarray:
    """Component label per contig lane: the minimum contig id reachable
    (undirected), matching ContigGraph.components() ordering.  -1 on
    non-contig lanes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    C2 = int(ca.out_edges.shape[1])
    n = int(ca.n_contigs)
    out_e = np.asarray(ca.out_edges[:, :n])  # [4, n]
    valid = out_e >= 0
    src = np.broadcast_to(np.arange(n, dtype=np.int64)[None, :], out_e.shape)[
        valid
    ]
    tgt = out_e[valid].astype(np.int64)
    adj = coo_matrix(
        (np.ones(len(src), np.int8), (src, tgt)), shape=(n, n)
    )
    _, raw = _cc(adj, directed=True, connection="weak")
    # relabel each component by its minimum member id (the oracle's
    # deterministic labeling)
    min_id = np.full(raw.max(initial=-1) + 1, np.iinfo(np.int64).max)
    np.minimum.at(min_id, raw, np.arange(n, dtype=np.int64))
    labels = np.full(C2, -1, np.int64)
    if n:
        labels[:n] = min_id[raw]
    return labels


def components_to_lists(labels: np.ndarray, n_contigs: int) -> list[list[int]]:
    """Host: component label array -> oracle-format component lists
    (sorted ids, ordered by minimum member = label)."""
    labels = np.asarray(labels[:n_contigs])
    order = np.argsort(labels, kind="stable")
    out: list[list[int]] = []
    prev = None
    for cid in order:
        l = labels[cid]
        if l != prev:
            out.append([])
            prev = l
        out[-1].append(int(cid))
    return out


def bucket_components(
    sizes: list[int], bucket_edges: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
) -> dict[int, list[int]]:
    """Group component indices into padded size classes (components of
    size <= edge go in bucket `edge`); oversized ones land in bucket 0
    (processed individually)."""
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sizes):
        for e in bucket_edges:
            if s <= e:
                buckets.setdefault(e, []).append(i)
                break
        else:
            buckets.setdefault(0, []).append(i)
    return buckets
