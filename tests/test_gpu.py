"""Tests that need the card (marker `gpu`).  They skip on the CPU;
chip_smoke.py runs them on the GPU.  Each compares the device result
with an exact reference at a real width: the float32 and integer
semantics are specified exactly, so no tolerance applies."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _hilo(keys: np.ndarray):
    import jax.numpy as jnp

    return (
        jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def test_lookup_exact_at_correction_width(gpu, rng):
    """8 x C probes against a C = 2^22 table with SENTINEL pads: hits
    and hit indices equal numpy searchsorted's."""
    from shannon_tpu.ops.spectrum import lookup_hilo

    C, n_real = 1 << 22, 3_000_000
    real = np.unique(rng.integers(0, 1 << 48, size=n_real, dtype=np.uint64))
    table = np.full(C, np.uint64(0xFFFFFFFFFFFFFFFF))
    table[: len(real)] = real
    q = np.concatenate([
        rng.choice(real, size=4 * C),
        rng.integers(0, 1 << 48, size=4 * C - 1, dtype=np.uint64),
        np.array([0xFFFFFFFFFFFFFFFF], np.uint64),  # the pad key itself
    ])
    idx, hit = lookup_hilo(*_hilo(table), *_hilo(q))
    pos = np.minimum(np.searchsorted(table, q), C - 1)
    want = table[pos] == q
    np.testing.assert_array_equal(np.asarray(hit), want)
    np.testing.assert_array_equal(np.asarray(idx)[want], pos[want])


def test_correct_spectrum_strand_specific_matches_oracle(gpu, rng):
    """chip_smoke.py's parity phase covers the canonical spectrum; this
    covers the strand-specific one."""
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.oracle.correction import correct_kmers
    from shannon_tpu.oracle.counting import count_kmers
    from shannon_tpu.ops.correction import correct_spectrum
    from shannon_tpu.ops.count import count_reads_spectrum
    from shannon_tpu.sim import simulate_expression

    _ts, reads = simulate_expression(rng, 8_000, n_transcripts=20)
    k = 24
    cfg = AssemblyConfig(k=k, min_abundance=2, strand_specific=True)
    spec = count_reads_spectrum(
        pack_reads(reads), k=k, capacity=1 << 22, canonical=False
    )
    got = correct_spectrum(
        spec, k, 2, cfg.sibling_ratio, cfg.correction_rounds,
        canonical=False, error_rate=cfg.error_rate,
    )
    assert got.to_dict() == correct_kmers(count_kmers(reads, k, True), cfg)


def test_sparse_flow_kernel_matches_host(gpu, rng):
    """A batch above the host threshold runs the device kernel; every
    node's pairings equal the host solver's."""
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.oracle.nodegraph import Node, NodeGraph
    from shannon_tpu.oracle.sparseflow import solve_node
    from shannon_tpu.ops.sparseflow import solve_nodes_device
    from shannon_tpu.sim import random_seq

    nodes, xs = [], []
    for _ in range(300):
        base = len(nodes)
        ab = [float(x) for x in rng.integers(1, 40, size=6)]
        for j in range(3):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[j],
                              klen=10))
        nodes.append(Node(seq=random_seq(rng, 30), abundance=sum(ab[:3]),
                          klen=10))
        for j in range(3):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[3 + j],
                              klen=10))
        xs.append(base + 3)
    g = NodeGraph(k=21, nodes=nodes)
    for v in xs:
        for u in (v - 3, v - 2, v - 1):
            g.add_edge(u, v)
        for w in (v + 1, v + 2, v + 3):
            g.add_edge(v, w)
    cfg = AssemblyConfig(k=21)
    dev = solve_nodes_device(g, xs, cfg)
    for v in xs:
        assert sorted(dev[v]) == sorted(solve_node(g, v, cfg)), v


def test_peak_memory_is_reported(gpu):
    import jax.numpy as jnp

    from shannon_tpu.utils.device import peak_bytes_in_use

    x = jnp.ones((1 << 24,), jnp.float32).block_until_ready()
    assert peak_bytes_in_use() >= x.nbytes
