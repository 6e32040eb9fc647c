"""Read batching/packing: host-side container crossing to the device.

The reference streams reads as text lines; the rebuild's device kernels need
fixed-shape arrays (SURVEY.md §8 hard part 2).  A ``ReadBatch`` holds the
reads **packed-resident** (docs/SCALING.md item 1): the
2-bit ``uint32`` word matrix (16 bases/word) that IS the host->device
transfer format, plus per-read lengths and an optional invalid-position
mask — 4x smaller than the former ``[n, pad] uint8`` code matrix, which was
the only remaining linear-in-reads host structure (12GB at the 100M-read
north star vs 3GB packed).  The uint8 view is materialized on demand
(`codes` property / `codes_rows`) for the oracle-parity paths and tests;
the hot paths (counting, threading) slice words directly and never build
it.

Padding convention: positions >= length hold ``BASE_INVALID`` in the code
view; mid-read invalid bases (N) are recorded in the bit-packed ``mask``
(absent when the batch has none — the overwhelming common case).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from shannon_tpu.io.dna import BASE_INVALID, decode_seq, encode_seq


class ReadBatch:
    """Packed-resident read batch.

    Construct from a uint8 code matrix (``ReadBatch(codes=..., lengths=...)``
    — the historical constructor; codes are packed and dropped) or directly
    from packed words (``ReadBatch(words=..., lengths=..., pad_length=...,
    mask=...)`` — the zero-copy path of the native ingest)."""

    __slots__ = ("words", "lengths", "paired", "pad_length", "mask")

    def __init__(
        self,
        codes: np.ndarray | None = None,
        lengths: np.ndarray | None = None,
        paired: bool = False,
        *,
        words: np.ndarray | None = None,
        pad_length: int | None = None,
        mask: np.ndarray | None = None,
    ):
        if lengths is None:
            raise ValueError("lengths is required")
        self.lengths = np.asarray(lengths, np.int32)
        self.paired = bool(paired)
        if codes is not None:
            codes = np.asarray(codes, np.uint8)
            self.pad_length = int(codes.shape[1])
            self.words = pack_words(codes)
            self.mask = invalid_mask_words(codes, self.lengths)
        else:
            if words is None or pad_length is None:
                raise ValueError("need codes, or words + pad_length")
            self.words = np.asarray(words, np.uint32)
            self.pad_length = int(pad_length)
            self.mask = mask

    @property
    def n_reads(self) -> int:
        return int(self.words.shape[0])

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    @property
    def codes(self) -> np.ndarray:
        """Materialized uint8 code view of the WHOLE batch (oracle-parity
        paths, tests).  O(n * pad) fresh allocation per access — hot paths
        must slice `words` / use `codes_rows` instead."""
        return self.codes_rows(0, self.n_reads)

    def codes_rows(self, s: int, e: int) -> np.ndarray:
        """Materialized uint8 code view of rows [s, e)."""
        return unpack_words(
            self.words[s:e],
            self.lengths[s:e],
            self.pad_length,
            None if self.mask is None else self.mask[s:e],
        )

    def mask_rows(self, s: int, e: int) -> np.ndarray | None:
        """Invalid-position mask of rows [s, e), or None when those rows
        contain no mid-read invalid bases (keeps the common-case device
        program mask-free even when some OTHER slice of the batch has
        N's)."""
        if self.mask is None:
            return None
        m = self.mask[s:e]
        return m if m.any() else None

    def sequences(self) -> list[str]:
        codes = self.codes
        return [
            decode_seq(codes[i, : self.lengths[i]])
            for i in range(self.n_reads)
        ]

    def packed_words(self) -> np.ndarray:
        """The resident 2-bit word matrix (kept for callers of the old
        packing API; now a no-op accessor)."""
        return self.words

    def pad_to(self, n_reads: int) -> "ReadBatch":
        """Zero-length-pad the batch to exactly n_reads rows (static shapes
        for jit; padded rows produce no valid k-mers)."""
        if n_reads < self.n_reads:
            raise ValueError(f"cannot shrink batch {self.n_reads} -> {n_reads}")
        if n_reads == self.n_reads:
            return self
        pad = n_reads - self.n_reads
        words = np.pad(self.words, ((0, pad), (0, 0)))
        lengths = np.pad(self.lengths, (0, pad))
        mask = (
            None if self.mask is None else np.pad(self.mask, ((0, pad), (0, 0)))
        )
        return ReadBatch(
            words=words, lengths=lengths, paired=self.paired,
            pad_length=self.pad_length, mask=mask,
        )

    def rows(self, sel) -> "ReadBatch":
        """Row-subset batch (slice or index array)."""
        return ReadBatch(
            words=self.words[sel],
            lengths=self.lengths[sel],
            paired=self.paired,
            pad_length=self.pad_length,
            mask=None if self.mask is None else self.mask[sel],
        )


def pack_words(codes: np.ndarray) -> np.ndarray:
    """2-bit pack [n, L] uint8 codes to [n, ceil(L/16)] uint32 words,
    16 bases/word, base j of a word in bits [2j, 2j+2).  Invalid bases
    (code >= 4: mid-read N or padding) pack as 0; consumers recover
    validity from `lengths` plus invalid_mask_words when a batch has
    mid-read invalid bases.

    This is THE host->device transfer format of the hot path (SURVEY.md
    §8 M1 "2-bit-packed read batches"): the 100bp counting batch is
    6.55MB as uint8 vs 1.83MB packed, 3.6x fewer bytes to upload for
    counting AND threading.  It is also the RESIDENT host format
    (ReadBatch.words)."""
    n, L = codes.shape
    W = (L + 15) // 16
    padded = np.zeros((n, W * 16), dtype=np.uint32)
    np.copyto(padded[:, :L], codes, casting="unsafe")
    padded[padded >= 4] = 0
    shifts = (2 * (np.arange(W * 16, dtype=np.uint32) % 16)).reshape(1, -1)
    return (padded << shifts).reshape(n, W, 16).sum(axis=2, dtype=np.uint32)


def unpack_words(
    words: np.ndarray,
    lengths: np.ndarray,
    pad_length: int,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """Inverse of pack_words (+ mask): [n, W] uint32 -> [n, pad_length]
    uint8 codes with BASE_INVALID past each read's length and at masked
    (mid-read N) positions.  Exact round-trip of the encode: every
    non-ACGT input base encodes to BASE_INVALID, whose position is in
    the mask, so codes -> (words, mask) -> codes is the identity."""
    words = np.asarray(words, np.uint32)
    n, W = words.shape
    shifts = (2 * (np.arange(W * 16, dtype=np.uint32) % 16)).reshape(1, -1)
    codes = (
        (np.repeat(words, 16, axis=1) >> shifts) & np.uint32(3)
    ).astype(np.uint8)[:, :pad_length]
    inread = np.arange(pad_length, dtype=np.int32)[None, :] < np.asarray(
        lengths, np.int32
    )[:, None]
    codes[~inread] = BASE_INVALID
    if mask is not None:
        mshift = (np.arange(mask.shape[1] * 32, dtype=np.uint32) % 32).reshape(
            1, -1
        )
        bits = (
            (np.repeat(np.asarray(mask, np.uint32), 32, axis=1) >> mshift)
            & np.uint32(1)
        ).astype(bool)[:, :pad_length]
        codes[bits] = BASE_INVALID
    return codes


def invalid_mask_words(
    codes: np.ndarray, lengths: np.ndarray, force: bool = False
) -> np.ndarray | None:
    """Bit-packed mid-read-invalid mask for a packed batch: bit (j % 32)
    of word j // 32 is set where codes[i, j] >= 4 AND j < lengths[i]
    (an N inside the read — the only validity information pack_words
    loses; tail padding is recovered from `lengths` alone).  Returns
    None when the batch has no mid-read invalid bases (the overwhelming
    common case), so the mask upload and its separate device program
    are only paid when real N's exist.  force=True always returns the
    mask (multi-process callers need uniform program structure across
    hosts)."""
    n, L = codes.shape
    inread = np.arange(L, dtype=np.int32)[None, :] < np.asarray(
        lengths, np.int32
    )[:, None]
    bad = (codes >= 4) & inread
    if not force and not bad.any():
        return None
    W = (L + 31) // 32
    padded = np.zeros((n, W * 32), dtype=np.uint32)
    padded[:, :L] = bad
    shifts = (np.arange(W * 32, dtype=np.uint32) % 32).reshape(1, -1)
    return (padded << shifts).reshape(n, W, 32).sum(axis=2, dtype=np.uint32)


def zero_mask_words(n: int, pad_length: int) -> np.ndarray:
    """All-clear mask of the right shape (multi-process force-mask for
    batches that have none — program structure must agree across
    hosts)."""
    return np.zeros((n, (pad_length + 31) // 32), np.uint32)


def auto_pad_length(max_len: int) -> int:
    """Pad grid for pad_length=0 (auto): the smallest multiple of 32
    >= max_len, floored at 96.  The coarse grid keeps the set of
    compiled device shapes dataset-independent (76-96bp libraries share
    the 96 pad, 100-128bp the classic 128, 129-160bp — incl. the
    dominant 150bp Illumina shape — 160), so auto mode never silently
    truncates and never mints a fresh XLA program per read length."""
    return max(96, 32 * ((max_len + 31) // 32))


def pack_reads(
    seqs: Iterable[str] | Sequence[str],
    pad_length: int = 0,
    paired: bool = False,
    chunk: int = 1 << 16,
) -> ReadBatch:
    """Encode + pad a list of sequences into a (packed-resident)
    ReadBatch.

    pad_length=0 (auto): sized to the longest read on the 32-base grid
    (auto_pad_length) — no truncation ever.  Explicit pad_length:
    longer reads are truncated (callers surface the count; see
    pipeline stats); shorter reads are BASE_INVALID-padded.  The uint8
    staging matrix is built per `chunk` rows so peak host memory stays
    words-sized, not codes-sized."""
    seq_list = list(seqs)
    n = len(seq_list)
    if pad_length == 0:
        pad_length = auto_pad_length(
            max((len(s) for s in seq_list), default=1)
        )
    W = (pad_length + 15) // 16
    words = np.empty((n, W), np.uint32)
    lengths = np.zeros(n, dtype=np.int32)
    masks: list[tuple[int, np.ndarray]] = []
    for s0 in range(0, max(n, 1), chunk):
        e0 = min(s0 + chunk, n)
        codes = np.full((e0 - s0, pad_length), BASE_INVALID, dtype=np.uint8)
        for i in range(s0, e0):
            enc = encode_seq(seq_list[i])[:pad_length]
            codes[i - s0, : len(enc)] = enc
            lengths[i] = len(enc)
        words[s0:e0] = pack_words(codes)
        m = invalid_mask_words(codes, lengths[s0:e0])
        if m is not None:
            masks.append((s0, m))
    if masks:
        mask = zero_mask_words(n, pad_length)
        for s0, m in masks:
            mask[s0 : s0 + m.shape[0]] = m
    else:
        mask = None
    return ReadBatch(
        words=words, lengths=lengths, paired=paired,
        pad_length=pad_length, mask=mask,
    )
