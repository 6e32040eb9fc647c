"""Device batched sparse-flow solver parity vs oracle solver,
including degenerate tie cases (SURVEY.md §8 hard part 4)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.oracle.sparseflow import greedy_decompose, tie_hash
from shannon_tpu.ops.sparseflow import MAXD, batched_greedy


def _device_one(a, b, seed=None):
    M, N = len(a), len(b)
    ap = np.zeros((1, MAXD), np.float32)
    bp = np.zeros((1, MAXD), np.float32)
    ap[0, :M] = a
    bp[0, :N] = b
    F = np.asarray(
        batched_greedy(
            jnp.asarray(ap), jnp.asarray(bp),
            jnp.asarray(np.array([seed or 0], np.uint32)),
            jnp.asarray(np.array([seed is not None])),
        )
    )[0, :M, :N]
    return F


def _oracle_F(a, b, seed=None):
    F = np.zeros((len(a), len(b)), np.float32)
    for i, j, f in greedy_decompose(
        np.asarray(a, np.float32), np.asarray(b, np.float32), seed
    ):
        F[i, j] += np.float32(f)
    return F


CASES = [
    ([5.0, 3.0], [5.0, 3.0]),
    ([5.0, 3.0], [4.0, 4.0]),
    ([10.0, 1.0, 1.0], [6.0, 6.0]),
    ([2.0, 2.0, 2.0], [2.0, 2.0, 2.0]),  # fully degenerate ties
    ([7.5, 2.5], [2.5, 2.5, 5.0]),
    ([1e-8, 5.0], [5.0, 1e-8]),  # near-zero margins
    ([4.0], [1.0, 1.0, 1.0, 1.0]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("seed", [None, 1, 123456789])
def test_greedy_parity(case, seed):
    a, b = CASES[case]
    np.testing.assert_array_equal(_device_one(a, b, seed), _oracle_F(a, b, seed))


def test_greedy_parity_random(rng):
    for _ in range(30):
        M = int(rng.integers(1, MAXD + 1))
        N = int(rng.integers(1, MAXD + 1))
        a = rng.integers(1, 20, size=M).astype(np.float32)
        b = rng.integers(1, 20, size=N).astype(np.float32)
        s = 0.5 * (a.sum() + b.sum())
        a *= s / a.sum()
        b *= s / b.sum()
        for seed in (None, int(rng.integers(0, 2**31))):
            np.testing.assert_array_equal(
                _device_one(a, b, seed), _oracle_F(a, b, seed)
            )


def test_tie_hash_matches_device():
    ii, jj = np.meshgrid(np.arange(8, dtype=np.uint32),
                         np.arange(8, dtype=np.uint32), indexing="ij")
    host = tie_hash(ii, jj, 42)
    from shannon_tpu.ops.sparseflow import _tie_hash_dev

    dev = np.asarray(
        _tie_hash_dev(jnp.asarray(ii.astype(np.int32)),
                      jnp.asarray(jj.astype(np.int32)),
                      jnp.uint32(42))
    )
    np.testing.assert_array_equal(host, dev)


def test_solve_nodes_device_matches_host(rng):
    """Full pipeline-level check: device solver plugged into sparse_flow
    gives the same splits as the host solver on an isoform graph."""
    from shannon_tpu.oracle.assemble import assemble_oracle
    from shannon_tpu.oracle.correction import clip_tips, correct_kmers
    from shannon_tpu.oracle.counting import count_kmers
    from shannon_tpu.oracle.graph import build_contigs
    from shannon_tpu.oracle.multibridge import multibridge, thread_reads
    from shannon_tpu.oracle.nodegraph import NodeGraph
    from shannon_tpu.oracle.sparseflow import sparse_flow
    from shannon_tpu.io.dna import encode_seq
    from shannon_tpu.ops.sparseflow import solve_nodes_device
    from shannon_tpu.sim import random_seq, sample_reads, simulate_transcripts

    # shared middle segment LONGER than the read: an X-node no read can
    # bridge — only sparse flow resolves it (by abundance separation)
    a_, b_, c_, d_ = simulate_transcripts(rng, n=4, length=250)
    r = random_seq(rng, 120)
    iso = [a_ + r + b_, c_ + r + d_]
    reads = sample_reads(rng, iso, abundances=[4.0, 1.0], coverage=30,
                         read_length=70)
    cfg = AssemblyConfig(k=21)

    def run(solver):
        alive = clip_tips(correct_kmers(count_kmers(reads, cfg.k), cfg), cfg)
        cg = build_contigs(alive, cfg)
        paths, weights = thread_reads([encode_seq(s) for s in reads], cg, cfg)
        g = NodeGraph.from_contig_graph(cg, paths, weights)
        multibridge(g, cfg)
        n = sparse_flow(g, cfg, solver=solver)
        return n, sorted(
            (nd.seq, round(nd.abundance, 4))
            for nd in g.nodes if nd.alive
        )

    n_host, host_nodes = run(None)
    n_dev, dev_nodes = run(solve_nodes_device)
    assert n_host == n_dev
    assert host_nodes == dev_nodes
    assert n_host > 0  # the isoform X-node was actually split


def test_block_decompose_known_answer():
    """Known answer: greedy max-min's first pick
    min(6, 7) = 6 crosses the {3,4}x{7} / {6}x{1,5} block boundary, so
    EVERY restart yields 5 pairings; the exact decomposition gives the
    sparsest 4 = m + n - #blocks."""
    from shannon_tpu.oracle.sparseflow import block_decompose

    a = np.asarray([3.0, 4.0, 6.0], np.float32)
    b = np.asarray([1.0, 5.0, 7.0], np.float32)
    # plain greedy: 5 pairings regardless of tie seed
    for seed in (None, 1, 7, 99):
        assert len(greedy_decompose(a, b, seed)) == 5
    blocks = block_decompose(a, b, tol=1e-6)
    assert blocks == [((0, 1), (2,)), ((2,), (0, 1))]
    total = sum(
        len(greedy_decompose(a[list(r)], b[list(c)], None))
        for r, c in blocks
    )
    assert total == 4  # provably minimal: 3 + 3 - 2 blocks


def test_block_decompose_tolerance_and_ties():
    from shannon_tpu.oracle.sparseflow import block_decompose

    a = np.asarray([5.0, 5.05], np.float32)
    b = np.asarray([5.02, 5.04], np.float32)
    # within 2% tolerance the near-equal margins split diagonally
    blocks = block_decompose(a, b, tol=0.2)
    assert blocks == [((0,), (0,)), ((1,), (1,))]
    # zero tolerance: no exact decomposition -> []
    assert block_decompose(a, b, tol=0.0) == []
    # oversized nodes are skipped (m + n > 12)
    assert block_decompose(np.ones(8, np.float32), np.ones(8, np.float32), 1.0) == []


def test_solve_node_block_refinement_matches_device(rng):
    """The greedy-fails margin set, end to end through both solvers:
    solve_node and solve_nodes_device must agree and return the
    4-sparse decomposition."""
    from shannon_tpu.oracle.nodegraph import Node, NodeGraph
    from shannon_tpu.oracle.sparseflow import solve_node
    from shannon_tpu.ops.sparseflow import solve_nodes_device

    # X-node 0 with in-neighbors 1..3 (abundances 3,4,6; outdeg 1
    # each) and out-neighbors 4..6 (abundances 1,5,7; indeg 1 each)
    nodes = [Node(seq="X", abundance=13.0, klen=1)]
    for ab in (3.0, 4.0, 6.0):
        nodes.append(Node(seq=f"I{ab}", abundance=ab, klen=1, out=[0]))
    for ab in (1.0, 5.0, 7.0):
        nodes.append(Node(seq=f"O{ab}", abundance=ab, klen=1, inc=[0]))
    nodes[0].inc = [1, 2, 3]
    nodes[0].out = [4, 5, 6]
    g = NodeGraph(k=5, nodes=nodes, paths=[])
    cfg = AssemblyConfig(k=5)
    host = solve_node(g, 0, cfg)
    dev = solve_nodes_device(g, [0], cfg)[0]
    assert sorted(host) == sorted(dev)
    assert len(host) == 4
    # the in-6 neighbor must NOT pair with the out-7 neighbor (the
    # block-crossing pairing plain greedy always makes first)
    assert not any(u == 3 and w == 6 for u, w, _f in host)
    # disabling refinement reproduces legacy greedy (5 pairings)
    cfg0 = AssemblyConfig(k=5, sf_block_tol=0.0)
    legacy = solve_node(g, 0, cfg0)
    assert len(legacy) == 5
    assert sorted(legacy) == sorted(solve_nodes_device(g, [0], cfg0)[0])


def test_solve_nodes_device_large_batch_matches_host(rng):
    """>=33 jobs forces the packed device batch (smaller rounds dispatch
    to the host solver); every node's device
    pairings must equal the host solve_node's exactly."""
    from shannon_tpu.oracle.nodegraph import Node, NodeGraph
    from shannon_tpu.oracle.sparseflow import solve_node
    from shannon_tpu.ops.sparseflow import solve_nodes_device
    from shannon_tpu.sim import random_seq

    nodes: list[Node] = []
    xs: list[int] = []
    k = 21
    for i in range(40):
        base = len(nodes)
        # u0,u1 -> v -> w0,w1 with varied abundances (some degenerate)
        abset = [
            float(rng.integers(1, 8)), float(rng.integers(1, 8)),
            float(rng.integers(1, 8)), float(rng.integers(1, 8)),
        ]
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=abset[j],
                              klen=10))
        v_ab = (abset[0] + abset[1])
        nodes.append(Node(seq=random_seq(rng, 30), abundance=v_ab, klen=10))
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=abset[2 + j],
                              klen=10))
        g_v = base + 2
        xs.append(g_v)
    g = NodeGraph(k=k, nodes=nodes)
    for v in xs:
        g.add_edge(v - 2, v)
        g.add_edge(v - 1, v)
        g.add_edge(v, v + 1)
        g.add_edge(v, v + 2)
    cfg = AssemblyConfig(k=k)
    dev = solve_nodes_device(g, xs, cfg)
    assert len(dev) == len(xs)
    for v in xs:
        assert sorted(dev[v]) == sorted(solve_node(g, v, cfg)), v
