"""Device k-mer counting: sort + segment-reduce into a fixed-capacity
sorted spectrum (the Jellyfish replacement — SURVEY.md §3.2 row 1,
§8 M1).

Pipeline per batch:  extract (hi, lo) windows  ->  lexicographic two-key
sort (XLA variadic sort; a Pallas radix sort drops in behind the same
interface — ops/pallas/)  ->  run-start flags  ->  scatter-add counts
->  compact unique k-mers to the front.  Everything is fixed-shape; the
number of distinct k-mers is carried as a scalar (`n`), padding lanes
hold the all-ones SENTINEL so the table stays sorted and binary-search
ready.

Oracle parity: spectrum == shannon_tpu.oracle.counting.spectrum_arrays
of count_kmers (tested in tests/test_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shannon_tpu.ops.kmers import SENTINEL, extract_kmers, extract_kmers_packed


@jax.tree_util.register_pytree_node_class
@dataclass
class Spectrum:
    """Sorted unique-k-mer table: (hi, lo, count) arrays of static
    capacity, SENTINEL-padded past `n` entries."""

    hi: jnp.ndarray  # [C] uint32
    lo: jnp.ndarray  # [C] uint32
    count: jnp.ndarray  # [C] int32 (0 on padding)
    n: jnp.ndarray  # [] int32 — number of real entries

    @property
    def capacity(self) -> int:
        return int(self.hi.shape[0])

    def tree_flatten(self):
        return (self.hi, self.lo, self.count, self.n), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # ---- host-side conveniences (parity tests, graph handoff) --------
    def to_dict(self) -> dict[int, int]:
        n = int(self.n)
        hi = np.asarray(self.hi[:n], dtype=np.uint64)
        lo = np.asarray(self.lo[:n], dtype=np.uint64)
        cnt = np.asarray(self.count[:n])
        keys = (hi << np.uint64(32)) | lo
        return {int(k): int(c) for k, c in zip(keys, cnt)}

    def overflowed(self) -> bool:
        """True if the capacity was too small (last lane not padding)."""
        return bool(self.hi[-1] != SENTINEL)


def _sort3(hi, lo, cnt):
    return jax.lax.sort((hi, lo, cnt), num_keys=2)


def unique_first_sorted(
    hi: jnp.ndarray, lo: jnp.ndarray, payloads: tuple, capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray, tuple, jnp.ndarray]:
    """Scatter/gather-free dedupe of a sorted two-word key sequence:
    compact the first lane of every distinct key (SENTINEL pads last) to
    the front via a single packed-key SORT (same choice as
    _unique_reduce).  Returns (hi[capacity], lo[capacity], payloads at
    first lanes, n_unique).  Used where duplicate keys carry identical
    payloads (e.g. the oriented node table's palindrome dedupe in
    ops/condense.py)."""
    m = hi.shape[0]
    real = ~((hi == SENTINEL) & (lo == SENTINEL))
    prev_differs = jnp.ones(m, dtype=bool).at[1:].set(
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    )
    is_start = real & prev_differs
    n_unique = is_start.sum(dtype=jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (m, 1), 0)[:, 0]
    skey = jnp.where(is_start, iota, iota | jnp.uint32(0x80000000))
    _, c_hi, c_lo, *c_pay = jax.lax.sort(
        (skey, hi, lo, *payloads), num_keys=1
    )
    if m < capacity:
        padn = capacity - m
        c_hi = jnp.concatenate([c_hi, jnp.full(padn, SENTINEL, jnp.uint32)])
        c_lo = jnp.concatenate([c_lo, jnp.full(padn, SENTINEL, jnp.uint32)])
        c_pay = [
            jnp.concatenate([p, jnp.zeros(padn, p.dtype)]) for p in c_pay
        ]
    valid = (
        jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0] < n_unique
    )
    out_hi = jnp.where(valid, c_hi[:capacity], SENTINEL)
    out_lo = jnp.where(valid, c_lo[:capacity], SENTINEL)
    out_payloads = tuple(
        jnp.where(valid, p[:capacity], jnp.zeros((), p.dtype)) for p in c_pay
    )
    return out_hi, out_lo, out_payloads, n_unique


def _unique_reduce(hi: jnp.ndarray, lo: jnp.ndarray, cnt: jnp.ndarray, capacity: int) -> Spectrum:
    """From lexicographically sorted (hi, lo) with per-lane counts
    (SENTINEL lanes last), build the compacted unique spectrum.

    Compaction is a second SORT, not a scatter or gather (a choice made
    on the accelerator this was first built for, where sorts were the
    fast primitive; not measured on the H100, ROADMAP C1).  Run-start
    lanes get key = their position, other lanes key = position | MSB, so one single-key sort moves the unique
    entries to the front in order; per-run counts are differences of
    the count prefix-sum carried through the same sort."""
    m = hi.shape[0]
    real = ~((hi == SENTINEL) & (lo == SENTINEL))
    prev_differs = jnp.ones(m, dtype=bool).at[1:].set(
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    )
    is_start = real & prev_differs
    n_unique = is_start.sum(dtype=jnp.int32)
    csum = jnp.cumsum(cnt.astype(jnp.int32))
    total = csum[-1]
    csum_before = csum - cnt

    iota = jax.lax.broadcasted_iota(jnp.uint32, (m, 1), 0)[:, 0]
    skey = jnp.where(is_start, iota, iota | jnp.uint32(0x80000000))
    _, c_hi, c_lo, c_cb = jax.lax.sort(
        (skey, hi, lo, csum_before), num_keys=1
    )
    # static slices need m >= capacity + 1; counting batches satisfy
    # this (windows >> capacity is not required — guard with pad)
    if m < capacity + 1:
        pad_n = capacity + 1 - m
        c_hi = jnp.concatenate([c_hi, jnp.full(pad_n, SENTINEL, jnp.uint32)])
        c_lo = jnp.concatenate([c_lo, jnp.full(pad_n, SENTINEL, jnp.uint32)])
        c_cb = jnp.concatenate([c_cb, jnp.zeros(pad_n, jnp.int32)])
    idx = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0]
    valid = idx < n_unique
    out_hi = jnp.where(valid, c_hi[:capacity], SENTINEL)
    out_lo = jnp.where(valid, c_lo[:capacity], SENTINEL)
    nxt = jnp.where(idx + 1 < n_unique, c_cb[1 : capacity + 1], total)
    out_cnt = jnp.where(valid, nxt - c_cb[:capacity], 0)
    return Spectrum(
        hi=out_hi,
        lo=out_lo,
        count=out_cnt,
        n=n_unique,
    )


def _unique_reduce_unit(hi: jnp.ndarray, lo: jnp.ndarray, capacity: int) -> Spectrum:
    """_unique_reduce specialized to per-lane count == 1 on real lanes
    (the count_spectrum path).  After the two-key sort, real lanes are
    contiguous at the front, so csum_before[p] == p — the compaction key
    already carries it.  The compaction sort therefore needs only
    (skey, hi, lo): 12B/lane instead of 16B/lane of sort traffic.

    `hi` may arrive narrowed to uint16 (see count_spectrum); its
    sentinel is then 0xFFFF and the output is widened back to uint32."""
    m = hi.shape[0]
    hi_sent = (
        jnp.uint16(0xFFFF) if hi.dtype == jnp.uint16 else SENTINEL
    )
    real = ~((hi == hi_sent) & (lo == SENTINEL))
    n_real = real.sum(dtype=jnp.int32)
    prev_differs = jnp.ones(m, dtype=bool).at[1:].set(
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    )
    is_start = real & prev_differs
    n_unique = is_start.sum(dtype=jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (m, 1), 0)[:, 0]
    skey = jnp.where(is_start, iota, iota | jnp.uint32(0x80000000))
    skey, c_hi, c_lo = jax.lax.sort((skey, hi, lo), num_keys=1)
    pos = (skey & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    if m < capacity + 1:
        pad_n = capacity + 1 - m
        c_hi = jnp.concatenate([c_hi, jnp.full(pad_n, hi_sent, c_hi.dtype)])
        c_lo = jnp.concatenate([c_lo, jnp.full(pad_n, SENTINEL, jnp.uint32)])
        pos = jnp.concatenate([pos, jnp.zeros(pad_n, jnp.int32)])
    idx = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0]
    valid = idx < n_unique
    out_hi = jnp.where(valid, c_hi[:capacity].astype(jnp.uint32), SENTINEL)
    out_lo = jnp.where(valid, c_lo[:capacity], SENTINEL)
    nxt = jnp.where(idx + 1 < n_unique, pos[1 : capacity + 1], n_real)
    out_cnt = jnp.where(valid, nxt - pos[:capacity], 0)
    return Spectrum(hi=out_hi, lo=out_lo, count=out_cnt, n=n_unique)


def _spectrum_from_windows(hi, lo, k: int, capacity: int, canonical: bool) -> Spectrum:
    """Shared counting tail: flatten window k-mers, sort, segment-reduce."""
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    # hi narrows to uint16 when every real k-mer fits 16 hi bits AND the
    # all-ones pair cannot occur as a real k-mer: k <= 23 always (hi <
    # 2^14), k == 24 only under canonicalization (the all-T 24-mer's RC
    # is all-A < it, so hi == 0xFFFF && lo == 0xFFFFFFFF is unreachable).
    # Saves 25% of the two-key sort's traffic and 17% of the compaction
    # sort's.  uint32 SENTINEL wraps to 0xFFFF under the cast.
    if k <= 23 or (k == 24 and canonical):
        hi = hi.astype(jnp.uint16)
    # two-operand sort only: per-lane counts are implied (1 for real
    # lanes, 0 for SENTINEL pads) — a third sort operand would add 33%
    # to the sort's data movement for nothing
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    return _unique_reduce_unit(hi, lo, capacity)


@partial(jax.jit, static_argnames=("k", "capacity", "canonical"))
def count_spectrum(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    capacity: int,
    canonical: bool = True,
) -> Spectrum:
    """Count all k-mers of a read batch into a sorted Spectrum."""
    hi, lo, _ = extract_kmers(codes, lengths, k, canonical)
    return _spectrum_from_windows(hi, lo, k, capacity, canonical)


@partial(jax.jit, static_argnames=("k", "capacity", "canonical", "length"))
def count_spectrum_packed(
    words: jnp.ndarray,  # [n, ceil(L/16)] uint32 (io.pack.pack_words)
    lengths: jnp.ndarray,
    k: int,
    capacity: int,
    canonical: bool = True,
    length: int | None = None,
    mask: jnp.ndarray | None = None,
) -> Spectrum:
    """count_spectrum over the 2-bit transfer format — the production
    upload path (SURVEY.md §8 M1 / BASELINE north star "2-bit-packed
    read batches"): 3.6x fewer upload bytes than the uint8 codes for
    bit-identical output.  `mask` carries mid-read invalid positions
    and is only present for batches that contain them (keeps the
    common-case program mask-free)."""
    hi, lo, _ = extract_kmers_packed(words, lengths, k, canonical, length, mask)
    return _spectrum_from_windows(hi, lo, k, capacity, canonical)


@jax.jit
def _overflow_flag(hi: jnp.ndarray) -> jnp.ndarray:
    """Device-side Spectrum.overflowed(): last lane is a real entry.
    Kept as a jitted scalar program so drivers can fetch it with
    copy_to_host_async instead of a blocking per-batch round-trip."""
    return hi[-1] != SENTINEL


@partial(jax.jit, static_argnames=("capacity",))
def _merge_at(a: Spectrum, b: Spectrum, capacity: int) -> Spectrum:
    hi = jnp.concatenate([a.hi, b.hi])
    lo = jnp.concatenate([a.lo, b.lo])
    cnt = jnp.concatenate([a.count, b.count])
    hi, lo, cnt = _sort3(hi, lo, cnt)
    return _unique_reduce(hi, lo, cnt, capacity)


def merge_spectra(a: Spectrum, b: Spectrum) -> Spectrum:
    """Merge two sorted spectra (same capacity) into one: concat -> sort
    -> re-reduce.  Used shard-to-shard after the hash all-to-all
    (SURVEY.md §3.4)."""
    return _merge_at(a, b, a.capacity)


def _slice_spectrum(spec: Spectrum, cap: int) -> Spectrum:
    """Device-side shrink to `cap` lanes (requires cap >= spec.n; the
    tail being padding makes the slice exact).  No host roundtrip."""
    if cap >= spec.capacity:
        return spec
    return Spectrum(
        hi=spec.hi[:cap], lo=spec.lo[:cap], count=spec.count[:cap], n=spec.n
    )


def merge_spectra_fixed(a: Spectrum, b: Spectrum) -> Spectrum:
    """Batch-to-batch merge at the inputs' (equal) capacity: ONE
    compiled program for the whole counting run.  Every DISTINCT
    program costs a compile on a cold start, so the merge loop must not
    mint a new shape per batch, as content-sized merging would.  Callers fall back to merge_spectra_sized (growth) only
    when this overflows."""
    if a.capacity != b.capacity:
        raise ValueError(f"capacity mismatch {a.capacity} != {b.capacity}")
    return _merge_at(a, b, a.capacity)


def merge_spectra_sized(a: Spectrum, b: Spectrum) -> Spectrum:
    """Batch-to-batch merge at *tight* capacity: shrink both inputs to
    tight_capacity(n) lanes and merge into tight_capacity(na + nb).

    The growth path behind merge_spectra_fixed: used when the global
    table outgrows the per-batch capacity (overflow of the fixed-shape
    merge) — content-sized capacities mint new program shapes, each a
    fresh compile, so this stays off the common path.
    Host sync on a.n/b.n is fine here: the driver is already a host
    loop."""
    na, nb = int(a.n), int(b.n)
    cap_out = tight_capacity(na + nb)
    a = _slice_spectrum(a, tight_capacity(na))
    b = _slice_spectrum(b, tight_capacity(nb))
    return _merge_at(a, b, cap_out)


def tight_capacity(n: int, slack: float = 1.05, minimum: int = 1 << 19) -> int:
    """Smallest capacity >= n * slack on the geometric grid
    {2^k, 1.5 * 2^k}.  The graph stages run at this tight capacity
    instead of the counting table's: the node space is 2x the spectrum
    capacity, so never carry more padding into the graph phase than the
    corrected k-mer count needs.  The geometric grid (max 50% waste)
    keeps the set of distinct compiled shapes DATASET-INDEPENDENT: with
    a linear quantum every dataset size would mint fresh compiles for
    the merge/correction/condense programs; on the grid they hit the
    persistent cache across datasets."""
    want = max(int(n * slack) + 1, minimum)
    p = 1 << (want - 1).bit_length()  # smallest 2^k >= want
    return p // 4 * 3 if p // 4 * 3 >= want else p


def shrink_spectrum(spec: Spectrum) -> Spectrum:
    """Host-side re-wrap of a spectrum at tight_capacity(n) (no device
    compute; cheap array slicing)."""
    n = int(spec.n)
    cap = tight_capacity(n)
    if cap >= spec.capacity:
        return spec
    return Spectrum(
        hi=jnp.asarray(np.asarray(spec.hi[:cap])),
        lo=jnp.asarray(np.asarray(spec.lo[:cap])),
        count=jnp.asarray(np.asarray(spec.count[:cap])),
        n=jnp.int32(n),
    )


def spectrum_from_arrays(
    kmers: np.ndarray, counts: np.ndarray, capacity: int | None = None
) -> Spectrum:
    """Rebuild a device Spectrum from sorted uint64 key / count arrays
    (the stage-checkpoint format in pipeline.py)."""
    n = len(kmers)
    if capacity is None:
        capacity = tight_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} entries")
    hi = np.full(capacity, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(capacity, 0xFFFFFFFF, dtype=np.uint32)
    cnt = np.zeros(capacity, dtype=np.int32)
    kk = np.asarray(kmers, dtype=np.uint64)
    hi[:n] = (kk >> np.uint64(32)).astype(np.uint32)
    lo[:n] = (kk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    cnt[:n] = np.asarray(counts, dtype=np.int32)
    return Spectrum(
        hi=jnp.asarray(hi), lo=jnp.asarray(lo), count=jnp.asarray(cnt),
        n=jnp.int32(n),
    )


def pad_batch_rows(
    codes: np.ndarray, lengths: np.ndarray, batch_reads: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a partial batch up to a power-of-two row count (capped at
    batch_reads, floored at 16) so XLA programs are shape-canonical
    (compile-cache hits across datasets; padded rows yield no valid
    windows)."""
    rows_in = codes.shape[0]
    if rows_in == batch_reads:
        return codes, lengths
    rows = 1 << max(rows_in - 1, 1).bit_length()
    rows = min(max(rows, 16), batch_reads)
    if rows > rows_in:
        pad = rows - rows_in
        codes = np.pad(codes, ((0, pad), (0, 0)), constant_values=4)
        lengths = np.pad(lengths, (0, pad))
    return codes, lengths


def pad_batch_rows_words(
    words: np.ndarray,
    lengths: np.ndarray,
    mask: np.ndarray | None,
    batch_reads: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """pad_batch_rows for the packed-resident format (ReadBatch.words):
    zero word rows + zero lengths yield no valid windows."""
    rows_in = words.shape[0]
    if rows_in == batch_reads:
        return words, lengths, mask
    rows = 1 << max(rows_in - 1, 1).bit_length()
    rows = min(max(rows, 16), batch_reads)
    if rows > rows_in:
        pad = rows - rows_in
        words = np.pad(words, ((0, pad), (0, 0)))
        lengths = np.pad(lengths, (0, pad))
        if mask is not None:
            mask = np.pad(mask, ((0, pad), (0, 0)))
    return words, lengths, mask


def count_reads_spectrum(
    batch_codes,
    batch_lengths: np.ndarray | None = None,
    k: int = 24,
    capacity: int = 1 << 22,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
) -> Spectrum:
    """Host driver: stream read batches through count_spectrum_packed,
    merging into one spectrum (single-chip path; the sharded path lives
    in shannon_tpu/parallel).

    `batch_codes` is a packed-resident ReadBatch (the production path —
    word rows slice straight into the upload, no per-batch packing) or
    a legacy [n, L] uint8 code matrix + `batch_lengths` (packed once
    here).

    Transfer discipline: each batch uploads 2-bit packed (3.6x fewer
    bytes), and overflow checks are
    device-scalar flags fetched with copy_to_host_async and resolved
    ONE batch late — the next batch's upload+count is already dispatched
    before the driver blocks on any flag, so the old 2-blocking-fetches
    -per-batch pattern (~200ms of ~100ms-RTT stalls per 65k reads, most
    of count_s) disappears.  A speculative fixed-capacity merge that
    turns out overflowed is redone with the sized (growing) merge from
    its kept inputs — correctness is unchanged, only the sync moved.

    `capacity` bounds the distinct k-mers of any ONE batch; across
    batches the merged table grows at tight capacity, so the returned
    spectrum's capacity may exceed or undercut `capacity` — always >=
    its own n."""
    from shannon_tpu.io.pack import ReadBatch

    if isinstance(batch_codes, ReadBatch):
        batch = batch_codes
    else:
        batch = ReadBatch(codes=batch_codes, lengths=batch_lengths)
    n = batch.n_reads
    total: Spectrum | None = None
    # pending = (prev_total, part, part_flag, merged_flag) of the most
    # recent speculative step; resolved one batch later (or at the end)
    pending: tuple | None = None

    def _resolve() -> None:
        nonlocal total, pending
        if pending is None:
            return
        prev_total, part, pflag, mflag = pending
        pending = None
        if bool(pflag):
            raise RuntimeError(
                f"a read batch produced more than capacity={capacity} "
                "distinct k-mers; raise kmer_capacity or lower "
                "batch_reads"
            )
        if mflag is not None and bool(mflag):
            # speculative fixed merge overflowed: redo as a growing merge
            total = merge_spectra_sized(prev_total, part)

    for s in range(0, n, batch_reads):
        e = min(s + batch_reads, n)
        words, lengths, mask = pad_batch_rows_words(
            batch.words[s:e],
            batch.lengths[s:e],
            batch.mask_rows(s, e),
            batch_reads,
        )
        part = count_spectrum_packed(
            jnp.asarray(words),
            jnp.asarray(lengths),
            k,
            capacity,
            canonical,
            length=batch.pad_length,
            mask=None if mask is None else jnp.asarray(mask),
        )
        pflag = _overflow_flag(part.hi)
        pflag.copy_to_host_async()
        _resolve()  # previous step's flags landed while this batch uploaded
        if total is None:
            total = part
            pending = (None, part, pflag, None)
        elif total.capacity == part.capacity:
            merged = merge_spectra_fixed(total, part)
            mflag = _overflow_flag(merged.hi)
            mflag.copy_to_host_async()
            pending = (total, part, pflag, mflag)
            total = merged  # speculative; _resolve redoes on overflow
        else:  # already grown: stay on the sized path (host-synced, rare)
            pending = (None, part, pflag, None)
            total = merge_spectra_sized(total, part)
    _resolve()
    if total is None:
        total = Spectrum(
            hi=jnp.full(capacity, SENTINEL, jnp.uint32),
            lo=jnp.full(capacity, SENTINEL, jnp.uint32),
            count=jnp.zeros(capacity, jnp.int32),
            n=jnp.int32(0),
        )
    return total
