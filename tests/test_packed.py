"""Parity tests for the 2-bit packed transfer format (SURVEY.md §8 M1
"2-bit-packed read batches"): every packed-input
device program must be bit-identical to its uint8-codes twin, including
batches with mid-read N's (the only validity information pack_words
loses, recovered via invalid_mask_words)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.io.pack import invalid_mask_words, pack_reads, pack_words
from shannon_tpu.ops.count import count_spectrum, count_spectrum_packed
from shannon_tpu.ops.kmers import extract_kmers, extract_kmers_packed
from shannon_tpu.sim import random_seq, sample_reads, simulate_transcripts


def _batch_with_ns(rng, n=40, min_len=30, max_len=90, pad=96):
    seqs = [random_seq(rng, int(n_)) for n_ in rng.integers(min_len, max_len, size=n)]
    # mid-read N's in a few reads, one all-N read, one too-short read
    seqs[0] = seqs[0][:10] + "N" + seqs[0][11:]
    seqs[1] = "N" * len(seqs[1])
    seqs.append("ACG")
    return seqs, pack_reads(seqs, pad_length=pad)


def test_pack_words_roundtrip(rng):
    _, b = _batch_with_ns(rng)
    words = pack_words(b.codes)
    assert words.dtype == np.uint32
    assert words.shape == (b.n_reads, (b.pad_length + 15) // 16)
    # unpack host-side and compare to codes with invalid squashed to 0
    shifts = 2 * (np.arange(b.pad_length) % 16)
    got = (words[:, np.arange(b.pad_length) // 16] >> shifts) & 3
    expect = np.where(b.codes >= 4, 0, b.codes)
    np.testing.assert_array_equal(got, expect)


def test_invalid_mask_only_when_needed(rng):
    clean = pack_reads([random_seq(rng, 50) for _ in range(8)], pad_length=64)
    assert invalid_mask_words(clean.codes, clean.lengths) is None
    _, dirty = _batch_with_ns(rng)
    mask = invalid_mask_words(dirty.codes, dirty.lengths)
    assert mask is not None and mask.dtype == np.uint32
    # bit j set exactly where a mid-read invalid base sits
    bits = (mask[:, np.arange(dirty.pad_length) // 32]
            >> (np.arange(dirty.pad_length) % 32)) & 1
    inread = np.arange(dirty.pad_length)[None, :] < dirty.lengths[:, None]
    np.testing.assert_array_equal(bits.astype(bool), (dirty.codes >= 4) & inread)


@pytest.mark.parametrize("k", [11, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_extract_kmers_packed_parity(rng, k, canonical):
    _, b = _batch_with_ns(rng)
    hi, lo, valid = extract_kmers(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), k, canonical
    )
    words = pack_words(b.codes)
    mask = invalid_mask_words(b.codes, b.lengths)
    phi, plo, pvalid = extract_kmers_packed(
        jnp.asarray(words), jnp.asarray(b.lengths), k, canonical,
        length=b.pad_length,
        mask=None if mask is None else jnp.asarray(mask),
    )
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(pvalid))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(phi))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(plo))


def test_count_spectrum_packed_parity(rng):
    ts = simulate_transcripts(rng, n=3, length=300)
    reads = sample_reads(rng, ts, coverage=12, read_length=64, error_rate=0.02)
    reads[3] = reads[3][:20] + "N" + reads[3][21:]
    b = pack_reads(reads, pad_length=64)
    ref = count_spectrum(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), 24, 1 << 13
    )
    words = pack_words(b.codes)
    mask = invalid_mask_words(b.codes, b.lengths)
    got = count_spectrum_packed(
        jnp.asarray(words), jnp.asarray(b.lengths), 24, 1 << 13,
        length=64, mask=None if mask is None else jnp.asarray(mask),
    )
    assert got.to_dict() == ref.to_dict()


def test_thread_packed_parity(rng):
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.ops.condense import build_contig_arrays
    from shannon_tpu.ops.count import count_reads_spectrum
    from shannon_tpu.ops.thread import (
        thread_reads_device,
        thread_reads_device_packed,
    )

    k = 21
    ts = simulate_transcripts(rng, n=2, length=400)
    reads = sample_reads(rng, ts, coverage=12, read_length=70, error_rate=0.0)
    reads[1] = reads[1][:30] + "N" + reads[1][31:]
    b = pack_reads(reads, pad_length=96)
    spec = count_reads_spectrum(b.codes, b.lengths, k, 1 << 14)
    ca = build_contig_arrays(spec, k, canonical=True)
    ref = thread_reads_device(
        jnp.asarray(b.codes), jnp.asarray(b.lengths), ca, k
    )
    words = pack_words(b.codes)
    mask = invalid_mask_words(b.codes, b.lengths)
    got = thread_reads_device_packed(
        jnp.asarray(words), jnp.asarray(b.lengths), ca, k,
        length=b.pad_length,
        mask=None if mask is None else jnp.asarray(mask),
    )
    for a, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(g))


def test_sharded_packed_parity(rng):
    from shannon_tpu.parallel import make_mesh
    from shannon_tpu.parallel.distributed import (
        count_spectrum_sharded,
        count_spectrum_sharded_packed,
    )

    mesh = make_mesh(8)
    reads = [random_seq(rng, 60) for _ in range(64)]
    reads[5] = reads[5][:15] + "NN" + reads[5][17:]
    b = pack_reads(reads, pad_length=64)
    codes, lengths = jnp.asarray(b.codes), jnp.asarray(b.lengths)
    ref, ovf1 = count_spectrum_sharded(codes, lengths, 17, 1 << 12, mesh)
    words = pack_words(b.codes)
    mask = invalid_mask_words(b.codes, b.lengths)
    got, ovf2 = count_spectrum_sharded_packed(
        jnp.asarray(words), lengths, 17, 1 << 12, mesh,
        length=64, mask=None if mask is None else jnp.asarray(mask),
    )
    assert not bool(ovf1) and not bool(ovf2)
    assert got.to_dict() == ref.to_dict()


def test_packed_resident_roundtrip(rng):
    """ReadBatch stores words (round 5); the uint8 view must round-trip
    exactly, including mid-read N's (mask) and tail padding."""
    from shannon_tpu.io.dna import encode_seq
    from shannon_tpu.io.pack import ReadBatch, unpack_words

    seqs, b = _batch_with_ns(rng)
    assert b.words.dtype == np.uint32
    assert b.mask is not None  # the batch has N's
    codes = b.codes
    for i, s in enumerate(seqs):
        enc = encode_seq(s)
        np.testing.assert_array_equal(codes[i, : len(enc)], enc)
        assert (codes[i, len(enc):] == 4).all()
    # slice view == full view rows
    np.testing.assert_array_equal(b.codes_rows(1, 4), codes[1:4])
    # constructing from codes and from (words, mask) is identical
    b2 = ReadBatch(
        words=b.words, lengths=b.lengths, pad_length=b.pad_length,
        mask=b.mask,
    )
    np.testing.assert_array_equal(b2.codes, codes)
    # unpack_words without mask: N positions decode as packed (A)
    raw = unpack_words(b.words, b.lengths, b.pad_length, None)
    assert (raw[0] != codes[0]).sum() == 1  # exactly the one mid-read N


def test_packed_resident_mask_rows_sliced(rng):
    """mask_rows returns None for clean slices of a dirty batch, so the
    common-case device program stays mask-free per batch slice."""
    seqs, b = _batch_with_ns(rng)
    assert b.mask_rows(0, 2) is not None  # rows with N's
    assert b.mask_rows(3, 10) is None     # clean rows


def test_pad_to_and_rows_packed(rng):
    from shannon_tpu.io.pack import pack_reads

    seqs = [random_seq(rng, 50) for _ in range(5)]
    b = pack_reads(seqs, pad_length=64)
    p = b.pad_to(8)
    assert p.n_reads == 8 and (p.lengths[5:] == 0).all()
    np.testing.assert_array_equal(p.words[:5], b.words)
    r = b.rows(slice(1, 3))
    np.testing.assert_array_equal(r.codes, b.codes[1:3])
