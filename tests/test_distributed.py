"""Sharded counting parity on the 8-virtual-device CPU mesh
(SURVEY.md §5.3: collectives exercised without several GPUs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.count import count_spectrum
from shannon_tpu.parallel import count_spectrum_sharded, make_mesh
from shannon_tpu.oracle.counting import count_kmers
from shannon_tpu.sim import random_seq, sample_reads, simulate_transcripts


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _batch(rng, n_reads, L=72):
    reads = [random_seq(rng, L) for _ in range(n_reads)]
    return reads, pack_reads(reads, pad_length=L)


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


@pytest.mark.parametrize("k", [15, 24])
def test_sharded_matches_single_chip(rng, mesh, k):
    reads, b = _batch(rng, 64)
    cap = 1 << 12
    single = count_spectrum(jnp.asarray(b.codes), jnp.asarray(b.lengths), k, cap)
    sharded, overflow = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), k, cap, mesh
    )
    assert not bool(overflow)
    assert sharded.to_dict() == single.to_dict()
    assert sharded.to_dict() == count_kmers(reads, k)


def test_sharded_with_duplicates_across_shards(rng, mesh):
    # same transcript sampled everywhere: every shard holds overlapping
    # k-mers, so cross-shard count merging is actually exercised
    t = simulate_transcripts(rng, n=1, length=300)[0]
    reads = sample_reads(rng, [t], coverage=20, read_length=72)
    reads = reads[: (len(reads) // 8) * 8]
    b = pack_reads(reads, pad_length=72)
    sharded, overflow = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 21, 1 << 12, mesh
    )
    assert not bool(overflow)
    assert sharded.to_dict() == count_kmers(reads, 21)


def test_sharded_overflow_flag(rng, mesh):
    reads, b = _batch(rng, 64)
    _, overflow = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 15, 1 << 12, mesh,
        bucket_cap=8,  # absurdly small buckets must trip the flag
    )
    assert bool(overflow)


def test_sharded_midscale_skewed_parity(rng, mesh):
    """Midscale sharded parity at realistic per-device table sizes
    8,192 100bp reads from a skewed (log-normal) transcriptome:
    ~190k k-mer instances, ~50k distinct — per-device buckets see the
    real hash skew, and the default 2x bucket_cap slack must absorb it
    without tripping the overflow flag."""
    ts = simulate_transcripts(rng, n=40, length=600)
    abund = np.exp(rng.normal(0.0, 1.0, 40))
    reads = sample_reads(
        rng,
        ts,
        abundances=(abund / abund.mean()).tolist(),
        coverage=34,
        read_length=100,
        error_rate=0.01,
    )
    reads = reads[: (len(reads) // 8) * 8]
    assert len(reads) >= 8000
    b = pack_reads(reads, pad_length=128)
    cap = 1 << 17
    single = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 24, cap
    )
    sharded, overflow = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 24, cap, mesh
    )
    assert not bool(overflow)
    assert sharded.to_dict() == single.to_dict()
    # undersized buckets at the same load must be DETECTED, not silent
    _, overflow2 = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 24, cap, mesh,
        bucket_cap=1 << 10,
    )
    assert bool(overflow2)


def test_sharded_strand_specific(rng, mesh):
    reads, b = _batch(rng, 32)
    sharded, overflow = count_spectrum_sharded(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 17, 1 << 12, mesh,
        canonical=False,
    )
    assert not bool(overflow)
    assert sharded.to_dict() == count_kmers(reads, 17, strand_specific=True)


def test_batched_driver_builds_one_program(rng, mesh):
    """The batch driver builds its sharded program once per static
    configuration: later batches reuse it instead of tracing and
    compiling a fresh one, and the merged spectrum is the oracle's."""
    from shannon_tpu.parallel.distributed import (
        _sharded_packed_program,
        count_reads_spectrum_sharded,
    )

    reads, b = _batch(rng, 256)
    before = _sharded_packed_program.cache_info()
    spec, overflow = count_reads_spectrum_sharded(
        b, k=19, capacity=1 << 12, mesh=mesh, batch_reads=64
    )
    after = _sharded_packed_program.cache_info()
    assert not overflow
    assert spec.to_dict() == count_kmers(reads, 19)
    assert after.misses - before.misses <= 1
    assert after.hits - before.hits >= 3  # 4 batches, one build
