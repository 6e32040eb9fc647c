"""Time the primitives the device kernels are built from: one JSON line
per measurement, on whatever backend `jax.devices()` gives (a CPU run
exercises the script; only a GPU run says anything about the GPU).

    PYTHONPATH=. python scripts/bench_primitives.py [--lanes N]

Measurements:
  two_word_sort      lexicographic (hi, lo) uint32 sort at several lane
                     counts — the counting kernel's actual primitive
                     (ops/count.py uses jax.lax.sort(num_keys=2))
  scatter_permute    x[perm] = v random scatter of the same lanes — the
                     reorder primitive a radix pass would need
  gather_permute     v[perm] random gather (the scatter's adjoint)
  onehot_matmul      per-256-tile permutation as one-hot bf16 matmul —
                     the tensor-core formulation of a radix-pass reorder
  lookup_binsearch   16x neighbor-probe volume against a sorted 1.5M
                     spectrum
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from shannon_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ITERS = 5


def _time(fn, *args) -> float:
    out = fn(*args)
    jax.tree_util.tree_leaves(out)[0].block_until_ready()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(*args)
    jax.tree_util.tree_leaves(out)[0].block_until_ready()
    return (time.perf_counter() - t0) / ITERS * 1e3  # ms


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


@jax.jit
def _sort2(hi, lo):
    return jax.lax.sort((hi, lo), num_keys=2)


@jax.jit
def _scatter(v, perm):
    return jnp.zeros_like(v).at[perm].set(v)


@jax.jit
def _gather(v, perm):
    return v[perm]


@partial(jax.jit, static_argnames=("tile",))
def _onehot_permute(v, perm_in_tile, tile: int):
    # per-tile permutation y[t, i] = sum_j P[t, i, j] * x[t, j] with P
    # one-hot — the matmul formulation of a radix pass's local reorder
    x = v.reshape(-1, tile).astype(jnp.bfloat16)
    p = jax.nn.one_hot(perm_in_tile.reshape(-1, tile), tile,
                       dtype=jnp.bfloat16)
    return jnp.einsum("tij,tj->ti", p, x)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=5_000_000)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    dev = str(jax.devices()[0])

    for lanes in (1 << 20, args.lanes, 4 * args.lanes):
        hi = jnp.asarray(rng.integers(0, 1 << 16, lanes, np.uint32))
        lo = jnp.asarray(rng.integers(0, 1 << 32, lanes, np.uint32))
        ms = _time(_sort2, hi, lo)
        emit(primitive="two_word_sort", lanes=lanes, ms=round(ms, 2),
             mlanes_per_s=round(lanes / ms / 1e3, 1), device=dev)

    lanes = args.lanes
    v = jnp.asarray(rng.integers(0, 1 << 32, lanes, np.uint32))
    perm = jnp.asarray(rng.permutation(lanes).astype(np.int32))
    sort_ms = _time(_sort2, v, v)
    scatter_ms = _time(_scatter, v, perm)
    gather_ms = _time(_gather, v, perm)
    emit(primitive="scatter_permute", lanes=lanes, ms=round(scatter_ms, 2),
         vs_sort=round(scatter_ms / sort_ms, 1), device=dev)
    emit(primitive="gather_permute", lanes=lanes, ms=round(gather_ms, 2),
         vs_sort=round(gather_ms / sort_ms, 1), device=dev)

    tile = 256
    lanes_t = lanes // tile * tile
    vt = v[:lanes_t]
    pt = jnp.asarray(
        np.argsort(rng.random((lanes_t // tile, tile)), axis=1)
        .astype(np.int32)
        .reshape(-1)
    )
    ms = _time(_onehot_permute, vt, pt, tile)
    flops = 2 * lanes_t * tile  # [tile,tile] @ [tile] per tile
    emit(primitive="onehot_matmul_permute", lanes=lanes_t, tile=tile,
         ms=round(ms, 2), tflops=round(flops / ms / 1e9, 3), device=dev)

    # lookup: 16 neighbor probes per k-mer against a sorted spectrum
    from shannon_tpu.ops.spectrum import lookup_hilo

    C = 1_572_864
    NQ = 16 * C
    tbl = np.sort(rng.integers(0, 2**48, size=C, dtype=np.uint64))
    thi = jnp.asarray((tbl >> 32).astype(np.uint32))
    tlo = jnp.asarray((tbl & 0xFFFFFFFF).astype(np.uint32))
    q = rng.integers(0, 2**48, size=NQ, dtype=np.uint64)
    qhi = jnp.asarray((q >> 32).astype(np.uint32))
    qlo = jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32))
    ms = _time(jax.jit(lookup_hilo), thi, tlo, qhi, qlo)
    emit(primitive="lookup_binsearch", queries=NQ, table=C,
         ms=round(ms, 2), device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
