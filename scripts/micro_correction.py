"""Time the correction stage's device pieces on the 1M-read table.

    python scripts/micro_correction.py [n_reads]

Builds the raw spectrum of the benchmark dataset (sim.simulate_expression,
seed 11, default 1M reads) the way the pipeline does (count, shrink,
auto abundance cut), then prints one JSON line per measurement:

  lookup          lookup_hilo (binary search) at the correction probes'
                  shape (8 x C queries against the C-lane table) and at
                  the threading shape (25M queries against a 1.6M-lane
                  table), checked exactly against numpy searchsorted
  correction      correct_spectrum as the pipeline runs it: probe
                  lookups, then rescue and prune each as one while_loop

Times are the median of 3 runs after a warm-up, each ending in
block_until_ready.  The GPU only (utils/device.require_gpu).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from shannon_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

K = 24


def _median_s(fn, *args) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[1]


def _check_lookup(thi, tlo, qhi, qlo, idx, hit) -> None:
    """Exact against numpy searchsorted on the 64-bit keys."""
    t = (np.asarray(thi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        tlo
    ).astype(np.uint64)
    q = (np.asarray(qhi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        qlo
    ).astype(np.uint64)
    pos = np.minimum(np.searchsorted(t, q), len(t) - 1)
    want_hit = t[pos] == q
    got_hit = np.asarray(hit)
    assert np.array_equal(got_hit, want_hit), "lookup hits != searchsorted"
    assert np.array_equal(np.asarray(idx)[want_hit], pos[want_hit]), (
        "lookup indices != searchsorted"
    )


def _time_lookup(shape: str, thi, tlo, qhi, qlo, device) -> None:
    from shannon_tpu.ops.spectrum import lookup_hilo

    fn = jax.jit(lookup_hilo)
    idx, hit = fn(thi, tlo, qhi, qlo)
    _check_lookup(thi, tlo, qhi, qlo, idx, hit)
    print(json.dumps({
        "measure": "lookup", "shape": shape, "kernel": "binary_search",
        "table": int(thi.shape[0]), "queries": int(qhi.shape[0]),
        "s": _median_s(fn, thi, tlo, qhi, qlo), "exact": True,
        "device": device,
    }), flush=True)


def main() -> int:
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.oracle.correction import choose_min_abundance
    from shannon_tpu.ops import correction as corr
    from shannon_tpu.ops.count import count_reads_spectrum, shrink_spectrum
    from shannon_tpu.sim import simulate_expression
    from shannon_tpu.utils.device import device_info, nvidia_smi, require_gpu

    require_gpu()
    device = device_info()
    if device["platform"] == "gpu":
        device["card"] = nvidia_smi()[1]
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    cfg = AssemblyConfig()
    _ts, reads = simulate_expression(np.random.default_rng(11), n_reads)
    batch = pack_reads(reads, pad_length=0)
    spec = shrink_spectrum(
        count_reads_spectrum(batch, k=K, capacity=cfg.kmer_capacity)
    )
    min_ab = choose_min_abundance(
        np.asarray(corr.count_histogram(spec, 1024))
    )
    C = spec.capacity
    print(json.dumps({"measure": "table", "reads": len(reads),
                      "capacity": C, "kmers": int(spec.n),
                      "auto_min_abundance": min_ab}), flush=True)

    ph, pl = jax.jit(corr.probe_keys, static_argnums=(1, 2, 3))(
        spec, K, True, "sib"
    )
    _time_lookup("correction_probes", spec.hi, spec.lo,
                  ph.reshape(-1), pl.reshape(-1), device)
    del ph, pl

    rng = np.random.default_rng(0)
    tc, nq = 1_572_864, 25_165_824
    tbl = np.unique(rng.integers(0, 2**48, size=tc, dtype=np.uint64))
    q = np.concatenate([
        rng.choice(tbl, size=nq // 2),
        rng.integers(0, 2**48, size=nq - nq // 2, dtype=np.uint64),
    ])
    _time_lookup(
        "threading", jnp.asarray((tbl >> 32).astype(np.uint32)),
        jnp.asarray((tbl & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((q >> 32).astype(np.uint32)),
        jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32)), device,
    )

    def correct():
        return corr.correct_spectrum(
            spec, K, min_ab, cfg.sibling_ratio, cfg.correction_rounds,
            error_rate=cfg.error_rate,
        )

    out = correct()
    print(json.dumps({
        "measure": "correction", "capacity": C, "s": _median_s(correct),
        "kmers_out": int(out.n), "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
