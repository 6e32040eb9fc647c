"""Threading-kernel stage profile at production shapes: attribute where
the threading time goes before rebuilding anything.

Times, each ending in a fetch of the result:

  extract   extract_kmers_packed only
  lookup    extract + lookup_hilo against the node table
  windows   full _thread_windows (adds cid/off gathers + 3 row compacts)
  compact   + compact_thread_outputs (across-read compaction)
  e2e       + pack_evidence + download (the production driver chain)

Usage: PYTHONPATH=. python scripts/prof_thread.py [n_nodes_real]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from shannon_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()
import jax
import jax.numpy as jnp

from shannon_tpu.io.pack import pack_words
from shannon_tpu.ops.condense import ContigArrays
from shannon_tpu.ops.count import tight_capacity
from shannon_tpu.ops.kmers import SENTINEL, extract_kmers_packed
from shannon_tpu.ops.spectrum import lookup_hilo
from shannon_tpu.ops.thread import (
    _thread_windows,
    compact_thread_outputs,
    evidence_grid,
    pack_evidence,
    slice_nodes_for_threading,
    thread_reads_device_packed,
)

K = 24
N = 1 << 16
L = 100
N_REAL = int(sys.argv[1]) if len(sys.argv) > 1 else 1_600_000
C2 = 2 * tight_capacity(N_REAL)

rng = np.random.default_rng(0)
# node table: sorted unique 48-bit keys, ~N_REAL real + SENTINEL pad
keys = np.unique(rng.integers(0, 2**48, size=N_REAL, dtype=np.uint64))
nh = np.full(C2, 0xFFFFFFFF, np.uint32)
nl = np.full(C2, 0xFFFFFFFF, np.uint32)
nh[: len(keys)] = (keys >> 32).astype(np.uint32)
nl[: len(keys)] = (keys & 0xFFFFFFFF).astype(np.uint32)
cid = np.zeros(C2, np.int32)
cid[: len(keys)] = rng.integers(0, max(len(keys) // 8, 1), len(keys))
off = np.zeros(C2, np.int32)
z = jnp.zeros(C2, jnp.int32)
ca = ContigArrays(
    node_hi=jnp.asarray(nh), node_lo=jnp.asarray(nl),
    node_count=z, node_cid=jnp.asarray(cid), node_off=jnp.asarray(off),
    klen=z, count_sum=z,
    head_lane=z, tail_lane=z, out_edges=jnp.zeros((4, C2), jnp.int32),
    rc_pair=z, n_nodes=jnp.int32(len(keys)), n_contigs=jnp.int32(len(keys) // 8),
)

ca = slice_nodes_for_threading(ca)  # driver-level tight slice (round 5)
print(f"sliced table to {ca.node_hi.shape[0]} lanes", flush=True)
codes = rng.integers(0, 4, size=(N, L), dtype=np.uint8)
lengths = np.full(N, L, np.int32)
words_np = pack_words(codes)
lengths_j = jnp.asarray(lengths)


@jax.jit
def _extract(words, lengths):
    return extract_kmers_packed(words, lengths, K, canonical=False, length=L)


@jax.jit
def _lookup(words, lengths, nh, nl):
    hi, lo, valid = extract_kmers_packed(words, lengths, K, False, L)
    idx, hit = lookup_hilo(nh, nl, hi.reshape(-1), lo.reshape(-1))
    return idx, hit


@jax.jit
def _windows(words, lengths, ca):
    hi, lo, valid = extract_kmers_packed(words, lengths, K, False, L)
    return _thread_windows(hi, lo, valid, ca)


def bench(name, fn, reps=5):
    out = fn()
    jax.tree_util.tree_map(
        lambda a: np.asarray(a[-2:]) if hasattr(a, "shape") and a.ndim else None,
        out,
    )
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.tree_util.tree_map(
        lambda a: np.asarray(a[-2:]) if hasattr(a, "shape") and a.ndim else None,
        out,
    )
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:10s} {dt:8.1f} ms/batch   ({N/ (dt/1e3):,.0f} reads/s)", flush=True)
    return dt


def fresh_words():
    # the timed loop reuses ONE uploaded buffer to isolate device compute
    return jnp.asarray(words_np)


w = fresh_words()
print(f"table C2={C2} real={len(keys)}  batch {N}x{L}  windows {N*(L-K+1)/1e6:.1f}M", flush=True)

t0 = time.perf_counter()
w2 = jnp.asarray(words_np); w2.block_until_ready()
print(f"upload     {(time.perf_counter()-t0)*1e3:8.1f} ms ({words_np.nbytes/1e6:.2f} MB)", flush=True)

bench("extract", lambda: _extract(w, lengths_j))
bench("lookup", lambda: _lookup(w, lengths_j, ca.node_hi, ca.node_lo))
bench("windows", lambda: _windows(w, lengths_j, ca))


def _comp():
    outs = thread_reads_device_packed(w, lengths_j, ca, K, length=L)
    return compact_thread_outputs(*outs)


bench("compact", _comp)


def _e2e():
    outs = thread_reads_device_packed(w, lengths_j, ca, K, length=L)
    comp = compact_thread_outputs(*outs)
    c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_runs, totals = comp
    tot_e, tot_r = (int(x) for x in np.asarray(totals))
    cap_e = min(evidence_grid(tot_e), int(c_cid.shape[0]))
    cap_r = min(evidence_grid(tot_r, minimum=1 << 11), int(c_p0.shape[0]))
    buf = pack_evidence(
        c_cid, c_run, c_p0, c_p1, c_o0, c_o1, outs[2], n_runs, lengths_j,
        cap_e, cap_r,
    )
    return np.asarray(buf)


bench("e2e", _e2e)

# host-side per-batch costs
t0 = time.perf_counter()
for _ in range(5):
    pack_words(codes)
print(f"pack_words {((time.perf_counter()-t0)/5)*1e3:8.1f} ms/batch (host)", flush=True)
