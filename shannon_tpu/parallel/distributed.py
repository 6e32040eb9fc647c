"""Sharded k-mer counting: the distributed backbone (SURVEY.md §3.4).

Per device (shard_map over the 1-D mesh axis 'd'):

  1. extract + locally pre-count the shard's k-mers (sort + segment
     reduce) — combining before communicating, the same trick the
     reference gets from Jellyfish's per-thread hashes;
  2. hash-bucket the local unique (k-mer, count) entries by owner
     device (multiplicative hash mod D) into fixed-size buckets;
  3. all_to_all the buckets (the one communication-heavy phase);
  4. merge the D received buckets (sort + segment-sum of counts) —
     each device now owns the exact global counts of its hash slice;
  5. all_gather the slices and re-sort into the full sorted spectrum,
     replicated on every device (correction probes may touch any
     k-mer, so the corrected table is kept replicated; its size is
     bounded by kmer_capacity).

Bucket overflow (a pathologically skewed hash slice) is detected and
reported via the returned flag, never silent.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from shannon_tpu.ops.count import Spectrum, _sort3, _unique_reduce
from shannon_tpu.ops.kmers import SENTINEL, extract_kmers, extract_kmers_packed
from shannon_tpu.parallel.mesh import READS_AXIS


def _hash_dev(hi: jnp.ndarray, lo: jnp.ndarray, n_dev: int) -> jnp.ndarray:
    """Owner device of each k-mer: multiplicative hash of (hi, lo)."""
    h = lo * jnp.uint32(2654435761) + hi * jnp.uint32(0x9E3779B9)
    h ^= h >> 16
    return (h % jnp.uint32(n_dev)).astype(jnp.int32)


def count_spectrum_sharded(
    codes: jnp.ndarray,  # [N, L] uint8 (N divisible by n_dev)
    lengths: jnp.ndarray,  # [N] int32
    k: int,
    capacity: int,
    mesh: Mesh,
    canonical: bool = True,
    bucket_cap: int | None = None,
) -> tuple[Spectrum, jnp.ndarray]:
    """Global spectrum (replicated) + boolean overflow flag.

    `capacity` is the per-device local-spectrum capacity; the final
    table capacity is n_dev * bucket_cap * ... == n_dev * bucket_cap
    entries gathered, reduced back into `capacity` lanes — callers keep
    the same capacity contract as the single-chip path.
    """
    n_dev = mesh.devices.size
    if bucket_cap is None:
        # balanced hash => ~capacity/n_dev per bucket; 2x slack
        bucket_cap = max(-(-capacity // n_dev) * 2, 8)
    return _sharded_program(mesh, k, capacity, canonical, bucket_cap)(
        codes, lengths
    )


@lru_cache(maxsize=None)
def _sharded_program(mesh, k, capacity, canonical, bucket_cap):
    """The jitted shard_map of count_spectrum_sharded, built once per
    static configuration so later batches reuse its compiled program."""
    n_dev = mesh.devices.size

    def local(codes_l, lengths_l):
        # 1. local pre-count
        hi, lo, valid = extract_kmers(codes_l, lengths_l, k, canonical)
        return _sharded_tail(hi, lo, valid, n_dev, capacity, bucket_cap)

    return jax.jit(shard_map(
        local,
        mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    ))


def count_spectrum_sharded_packed(
    words: jnp.ndarray,  # [N, ceil(L/16)] uint32 (io.pack.pack_words)
    lengths: jnp.ndarray,
    k: int,
    capacity: int,
    mesh: Mesh,
    canonical: bool = True,
    bucket_cap: int | None = None,
    length: int | None = None,
    mask: jnp.ndarray | None = None,
) -> tuple[Spectrum, jnp.ndarray]:
    """count_spectrum_sharded over the 2-bit transfer format — identical
    collective structure and output; the packed
    upload is sharded over the reads axis like the codes were.  `mask`
    (mid-read invalid positions, io.pack.invalid_mask_words) is only
    passed for batches that contain them."""
    n_dev = mesh.devices.size
    if bucket_cap is None:
        bucket_cap = max(-(-capacity // n_dev) * 2, 8)
    args = (words, lengths) if mask is None else (words, lengths, mask)
    return _sharded_packed_program(
        mesh, k, capacity, canonical, bucket_cap, length, mask is not None
    )(*args)


@lru_cache(maxsize=None)
def _sharded_packed_program(mesh, k, capacity, canonical, bucket_cap,
                            length, with_mask):
    """The jitted shard_map of count_spectrum_sharded_packed, built once
    per static configuration so later batches reuse its compiled
    program."""
    n_dev = mesh.devices.size

    def local_packed(words_l, lengths_l, *mask_l):
        hi, lo, valid = extract_kmers_packed(
            words_l,
            lengths_l,
            k,
            canonical,
            length,
            mask_l[0] if mask_l else None,
        )
        return _sharded_tail(hi, lo, valid, n_dev, capacity, bucket_cap)

    in_specs = [P(READS_AXIS, None), P(READS_AXIS)]
    if with_mask:
        in_specs.append(P(READS_AXIS, None))
    return jax.jit(shard_map(
        local_packed,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(), P()),
        check_vma=False,
    ))


def _sharded_tail(hi, lo, valid, n_dev, capacity, bucket_cap):
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    ones = valid.reshape(-1).astype(jnp.int32)
    hi, lo, ones = _sort3(hi, lo, ones)
    spec_l = _unique_reduce(hi, lo, ones, capacity)

    # 2. bucket by owner device: sort local spectrum by (dev, hi, lo)
    dev = _hash_dev(spec_l.hi, spec_l.lo, n_dev)
    pad = (spec_l.hi == SENTINEL) & (spec_l.lo == SENTINEL)
    dev = jnp.where(pad, n_dev, dev)  # padding sorts last
    dev, bhi, blo, bcnt = jax.lax.sort(
        (dev, spec_l.hi, spec_l.lo, spec_l.count), num_keys=3
    )
    # position of each entry within its bucket
    idx = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0]
    first_of_dev = jnp.searchsorted(
        dev, jnp.arange(n_dev + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    within = idx - first_of_dev[jnp.clip(dev, 0, n_dev)]
    overflow = jnp.any((within >= bucket_cap) & (dev < n_dev))
    # scatter into [n_dev, bucket_cap] buckets
    tgt = jnp.where(
        (dev < n_dev) & (within < bucket_cap),
        dev * bucket_cap + within,
        n_dev * bucket_cap,
    )
    buf_hi = jnp.full(n_dev * bucket_cap + 1, SENTINEL, jnp.uint32)
    buf_lo = jnp.full(n_dev * bucket_cap + 1, SENTINEL, jnp.uint32)
    buf_cnt = jnp.zeros(n_dev * bucket_cap + 1, jnp.int32)
    buf_hi = buf_hi.at[tgt].set(bhi)
    buf_lo = buf_lo.at[tgt].set(blo)
    buf_cnt = buf_cnt.at[tgt].set(jnp.where(dev < n_dev, bcnt, 0))
    buf_hi = buf_hi[:-1].reshape(n_dev, bucket_cap)
    buf_lo = buf_lo[:-1].reshape(n_dev, bucket_cap)
    buf_cnt = buf_cnt[:-1].reshape(n_dev, bucket_cap)

    # 3. all-to-all: bucket j -> device j
    buf_hi = jax.lax.all_to_all(buf_hi, READS_AXIS, 0, 0, tiled=False)
    buf_lo = jax.lax.all_to_all(buf_lo, READS_AXIS, 0, 0, tiled=False)
    buf_cnt = jax.lax.all_to_all(buf_cnt, READS_AXIS, 0, 0, tiled=False)

    # 4. merge received buckets: exact counts of this device's slice,
    # compacted to bucket_cap lanes (real slice size ~capacity/n_dev)
    mh, ml, mc = _sort3(
        buf_hi.reshape(-1), buf_lo.reshape(-1), buf_cnt.reshape(-1)
    )
    slice_spec = _unique_reduce(mh, ml, mc, n_dev * bucket_cap)
    overflow = overflow | (slice_spec.n > bucket_cap)

    # 5. gather slices, re-sort, reduce into the final capacity
    gh = jax.lax.all_gather(slice_spec.hi[:bucket_cap], READS_AXIS, axis=0, tiled=True)
    gl = jax.lax.all_gather(slice_spec.lo[:bucket_cap], READS_AXIS, axis=0, tiled=True)
    gc = jax.lax.all_gather(slice_spec.count[:bucket_cap], READS_AXIS, axis=0, tiled=True)
    gh, gl, gc = _sort3(gh, gl, gc)
    # slices are disjoint: plain slice of the first `capacity` lanes
    final = Spectrum(
        hi=gh[:capacity], lo=gl[:capacity], count=gc[:capacity],
        n=jnp.minimum(
            (~((gh == SENTINEL) & (gl == SENTINEL))).sum(dtype=jnp.int32),
            capacity,
        ),
    )
    cap_overflow = (
        (~((gh == SENTINEL) & (gl == SENTINEL))).sum(dtype=jnp.int32)
        > capacity
    )
    overflow = overflow | cap_overflow
    return final, overflow


def count_reads_spectrum_sharded(
    batch_codes,
    batch_lengths=None,
    k: int = 24,
    capacity: int = 1 << 22,
    mesh: Mesh = None,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
) -> tuple[Spectrum, bool]:
    """Host driver for the sharded path: stream read batches through
    count_spectrum_sharded_packed, merging replicated results batch-to
    -batch (mirrors ops.count.count_reads_spectrum for the 1-chip path:
    packed-resident row slices upload directly, overflow flags fetched
    async and resolved one batch late so no blocking round-trip sits
    between batches).  `batch_codes`: a packed-resident ReadBatch or a
    legacy uint8 code matrix + `batch_lengths`.
    Returns (spectrum, overflowed)."""
    import numpy as np

    from shannon_tpu.io.pack import ReadBatch
    from shannon_tpu.ops.count import (
        _overflow_flag,
        merge_spectra_fixed,
        merge_spectra_sized,
    )

    if isinstance(batch_codes, ReadBatch):
        batch = batch_codes
    else:
        batch = ReadBatch(codes=batch_codes, lengths=batch_lengths)
    n_dev = mesh.devices.size
    n = batch.n_reads
    rows2 = NamedSharding(mesh, P(READS_AXIS, None))
    rows1 = NamedSharding(mesh, P(READS_AXIS))
    total: Spectrum | None = None
    overflowed = False
    pending: tuple | None = None  # (prev_total, part, ovf, merged_flag)

    def _resolve() -> None:
        nonlocal total, overflowed, pending
        if pending is None:
            return
        prev_total, part, ovf, mflag = pending
        pending = None
        overflowed |= bool(ovf)
        if mflag is not None and bool(mflag):
            total = merge_spectra_sized(prev_total, part)

    for s in range(0, n, batch_reads):
        e = min(s + batch_reads, n)
        words = batch.words[s:e]
        lengths = batch.lengths[s:e]
        mask = batch.mask_rows(s, e)
        rows = e - s
        if rows != batch_reads:
            tgt = 1 << max(rows - 1, 1).bit_length()
            tgt = min(max(tgt, 2 * n_dev), batch_reads)
            if tgt > rows:
                words = np.pad(words, ((0, tgt - rows), (0, 0)))
                lengths = np.pad(lengths, (0, tgt - rows))
                if mask is not None:
                    mask = np.pad(mask, ((0, tgt - rows), (0, 0)))
        # each device's row block goes straight to that device, not
        # through device 0
        part, ovf = count_spectrum_sharded_packed(
            jax.device_put(words, rows2), jax.device_put(lengths, rows1),
            k, capacity, mesh, canonical, length=batch.pad_length,
            mask=None if mask is None else jax.device_put(mask, rows2),
        )
        ovf.copy_to_host_async()
        _resolve()
        if total is None:
            total = part
            pending = (None, part, ovf, None)
        elif total.capacity == part.capacity:
            # fixed-shape merge (one program for the whole run); grow
            # only on overflow — see ops.count.merge_spectra_fixed
            merged = merge_spectra_fixed(total, part)
            mflag = _overflow_flag(merged.hi)
            mflag.copy_to_host_async()
            pending = (total, part, ovf, mflag)
            total = merged
        else:
            pending = (None, part, ovf, None)
            total = merge_spectra_sized(total, part)
    _resolve()
    if total is None:
        from shannon_tpu.ops.kmers import SENTINEL as _S

        total = Spectrum(
            hi=jnp.full(capacity, _S, jnp.uint32),
            lo=jnp.full(capacity, _S, jnp.uint32),
            count=jnp.zeros(capacity, jnp.int32),
            n=jnp.int32(0),
        )
    return total, overflowed
