"""Native (C++) ingest bindings: a ctypes loader that builds the
library on first use (SURVEY.md §3.2: the reference's throughput-
critical ingest lives in native code; so does ours).

The shared object is built from native/ingest.cpp with g++ -O3 into
native/build/ inside the checkout, and memoized.  A failed build raises:
plain FASTA/FASTQ files always take the native parser.  Gzip input has
its own Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent / "native"
_SRC = _ROOT / "ingest.cpp"
_SO = _ROOT / "build" / "shannon_tpu_ingest.so"
_lib: ctypes.CDLL | None = None


def _build() -> None:
    """Compile _SRC into _SO.  The object is written under a
    process-unique name and renamed into place, so concurrent builders
    (test workers) never load a half-written file."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         str(_SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native ingest library failed:\n{proc.stderr}"
        )
    os.replace(tmp, _SO)


def load() -> ctypes.CDLL:
    """Build (once) and load the native library; raises when the build
    or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_SO))
    lib.sti_count_records.restype = ctypes.c_long
    lib.sti_count_records.argtypes = [ctypes.c_char_p]
    lib.sti_max_seq_len.restype = ctypes.c_long
    lib.sti_max_seq_len.argtypes = [ctypes.c_char_p]
    lib.sti_parse_pack.restype = ctypes.c_long
    lib.sti_parse_pack.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
    ]
    lib.sti_range_count.restype = ctypes.c_long
    lib.sti_range_count.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
    ]
    lib.sti_parse_pack_records.restype = ctypes.c_long
    lib.sti_parse_pack_records.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
    ]
    lib.sti_range_parse.restype = ctypes.c_long
    lib.sti_range_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
    ]
    _lib = lib
    return _lib


def pack_file(path: str | os.PathLike, pad_length: int = 0):
    """Parse + encode a FASTA/FASTQ file into a ReadBatch: the native
    parser for plain files, the Python parser for gzip.  pad_length=0 =
    auto: sized to the file's longest read on the 32-base grid (one
    extra native scan; never truncates)."""
    from shannon_tpu.io.fastx import read_fastx
    from shannon_tpu.io.pack import ReadBatch, auto_pad_length, pack_reads

    path = Path(path)
    if path.suffix == ".gz":
        return pack_reads((s for _, s in read_fastx(path)), pad_length)
    lib = load()
    n = lib.sti_count_records(str(path).encode())
    if n < 0:
        # malformed for the native fast path; Python parser raises the
        # descriptive error (or handles the corner case)
        return pack_reads((s for _, s in read_fastx(path)), pad_length)
    if pad_length == 0:
        max_len = lib.sti_max_seq_len(str(path).encode())
        if max_len < 0:
            return pack_reads((s for _, s in read_fastx(path)), pad_length)
        pad_length = auto_pad_length(int(max_len))
    codes = np.empty((n, pad_length), dtype=np.uint8)
    lengths = np.empty(n, dtype=np.int32)
    got = lib.sti_parse_pack(
        str(path).encode(),
        pad_length,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
    )
    if got != n:
        return pack_reads((s for _, s in read_fastx(path)), pad_length)
    return ReadBatch(codes=codes, lengths=lengths, paired=False)


def pack_file_records(
    path: str | os.PathLike, skip: int, count: int, pad_length: int
):
    """Parse + encode records [skip, skip + count) by RECORD INDEX —
    the pair-aligned multi-host ingest primitive (SURVEY.md §8 M5): the
    left mate file is byte-range-split, each host converts its byte
    range to a record range, and BOTH mate files
    are then read at that record range, keeping every pair co-resident
    on one host.  The skip phase is a pure line scan (no encoding), so
    a host pays O(file) scanning but only O(file/H) parse+encode.
    Native for plain files; gzip (and a native parse that stops short
    on malformed input) parses-and-slices in Python."""
    from shannon_tpu.io.fastx import read_fastx
    from shannon_tpu.io.pack import ReadBatch, pack_reads

    path = Path(path)
    if path.suffix != ".gz":
        lib = load()
        codes = np.empty((max(count, 1), pad_length), dtype=np.uint8)
        lengths = np.empty(max(count, 1), dtype=np.int32)
        got = lib.sti_parse_pack_records(
            str(path).encode(), skip, pad_length,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            count,
        )
        if got == count:
            return ReadBatch(codes=codes[:count], lengths=lengths[:count])
    import itertools

    seqs = [
        s
        for _, s in itertools.islice(read_fastx(path), skip, skip + count)
    ]
    return pack_reads(seqs, pad_length)


def count_records_in_range(path: str | os.PathLike, lo: int, hi: int) -> int:
    """Records whose header byte lands in [lo, hi) (native; raises on
    malformed input)."""
    lib = load()
    n = lib.sti_range_count(str(Path(path)).encode(), lo, hi)
    if n < 0:
        raise ValueError(f"malformed FASTA/FASTQ for range count: {path}")
    return int(n)


def _py_range_records(path: Path, lo: int, hi: int) -> list[str]:
    """Pure-Python byte-range record extraction — same contract as the
    native sti_range_* functions (a record belongs to the range holding
    its header line's first byte; FASTQ resync = '@' line with '+' two
    lines later)."""
    out: list[str] = []
    with open(path, "rb") as fh:
        head = fh.read(2048)
        fmt = None
        for ln in head.splitlines():
            if not ln:
                continue
            fmt = "fasta" if ln[:1] == b">" else (
                "fastq" if ln[:1] == b"@" else None
            )
            break
        if fmt is None:
            raise ValueError(f"unrecognized FASTA/FASTQ: {path}")
        if lo <= 0:
            fh.seek(0)
        else:
            fh.seek(lo - 1)
            fh.readline()  # discard partial line (or the '\n' at lo-1)
        if fmt == "fasta":
            seq: list[bytes] = []
            in_rec = False
            while True:
                start = fh.tell()
                ln = fh.readline()
                if not ln:
                    break
                if ln[:1] == b">":
                    if in_rec:
                        out.append(b"".join(seq).decode("ascii"))
                    if start >= hi:
                        in_rec = False
                        break
                    seq, in_rec = [], True
                elif in_rec:
                    seq.append(ln.strip())
            if in_rec:
                out.append(b"".join(seq).decode("ascii"))
            return out
        # FASTQ resync: header = '@' line two lines before a '+' line
        held: list[tuple[int, bytes]] = []
        hdr_start = None
        first_seq = None
        while True:
            start = fh.tell()
            ln = fh.readline()
            if not ln:
                return out
            if (
                len(held) == 2
                and held[0][1][:1] == b"@"
                and ln[:1] == b"+"
            ):
                hdr_start = held[0][0]
                first_seq = held[1][1].strip()
                break
            held.append((start, ln))
            if len(held) > 2:
                held.pop(0)
        if hdr_start >= hi:
            return out
        out.append(first_seq.decode("ascii"))
        if not fh.readline():  # quality
            raise ValueError(f"truncated FASTQ: {path}")
        while True:
            start = fh.tell()
            hdr = fh.readline()
            if not hdr:
                break
            if start >= hi:
                break
            if hdr[:1] != b"@":
                raise ValueError(f"malformed FASTQ near byte {start}: {path}")
            seq = fh.readline()
            plus = fh.readline()
            qual = fh.readline()
            if not seq or not plus or not qual or plus[:1] != b"+":
                raise ValueError(f"truncated FASTQ: {path}")
            out.append(seq.strip().decode("ascii"))
        return out


def pack_file_range(
    path: str | os.PathLike, lo: int, hi: int, pad_length: int = 128
):
    """Parse + encode only the records whose header byte lands in
    [lo, hi) — the per-host ingest primitive (each host of N reads ~1/N
    of the file's bytes instead of parsing everything and slicing;
    SURVEY.md §8 M5).  Partitioning [0, file_size) over hosts yields
    every record exactly once.  Native parser; input it rejects as
    malformed goes to the Python reader, which names the fault."""
    from shannon_tpu.io.pack import ReadBatch, pack_reads

    path = Path(path)
    if path.suffix == ".gz":
        raise ValueError(
            "byte-range ingest requires an uncompressed file (gzip "
            "offsets are not record-addressable); decompress or use "
            "pack_file + record slicing"
        )
    lib = load()
    pb = str(path).encode()
    n = lib.sti_range_count(pb, lo, hi)
    if n < 0:
        return pack_reads(_py_range_records(path, lo, hi), pad_length)
    codes = np.empty((max(n, 1), pad_length), dtype=np.uint8)
    lengths = np.empty(max(n, 1), dtype=np.int32)
    got = lib.sti_range_parse(
        pb, lo, hi, pad_length,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
    )
    if got != n:
        return pack_reads(_py_range_records(path, lo, hi), pad_length)
    return ReadBatch(codes=codes[:n], lengths=lengths[:n], paired=False)
