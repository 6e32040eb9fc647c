"""Interactive e2e assembly measurement on the device.

Runs the full assembly TWICE in one process: the first (cold) run pays
the compiles, the second (steady) run is the production-throughput
number (a deployment streams many datasets through one resident
process).

    python scripts/measure_e2e.py [n_reads]
"""
import os, sys, time, json, resource
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np

n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 50000
from shannon_tpu.utils.jaxcache import enable_compilation_cache
enable_compilation_cache()
from shannon_tpu.utils.jaxdiag import count_programs  # distinct-program diagnostic
programs = count_programs()
from shannon_tpu.sim import simulate_expression
from shannon_tpu.pipeline import assemble
from shannon_tpu.config import AssemblyConfig
from shannon_tpu.utils.timing import StageTimer

from shannon_tpu.utils.device import require_gpu
require_gpu()
rng = np.random.default_rng(11)
# dataset/config knobs for scale points (SHANNON_E2E_NTR: transcriptome
# size; SHANNON_E2E_MIN_ABUND: abundance cutoff — 0 (default) = auto
# from the count histogram)
n_tr = int(os.environ.get("SHANNON_E2E_NTR", 500))
min_abund = int(os.environ.get("SHANNON_E2E_MIN_ABUND", 0))
t0 = time.perf_counter()
ts, reads = simulate_expression(rng, n_reads, n_transcripts=n_tr)
print(f"simulated {len(reads)} reads in {time.perf_counter()-t0:.1f}s", flush=True)
cfg = AssemblyConfig(
    min_abundance=min_abund,
    batch_reads=int(
        os.environ.get("SHANNON_E2E_BATCH_READS", AssemblyConfig.batch_reads)
    ),
)
out = {}
# SHANNON_E2E_PASSES=1: one pass only, recorded under BOTH labels with
# single_pass=true — for scale points where a second in-process pass
# does not fit in device memory
passes = int(os.environ.get("SHANNON_E2E_PASSES", 2))
labels = ("cold", "steady")[:passes] if passes >= 2 else ("steady",)
for label in labels:
    timer = StageTimer(echo=True)
    t0 = time.perf_counter()
    res = assemble(reads, cfg, backend="device", timer=timer)
    dt = time.perf_counter() - t0
    out[label] = {
        "e2e_s": round(dt, 2),
        "reads_per_s": round(len(reads) / dt, 1),
        "stages": {k: v for k, v in timer.stages.items()},
    }
    print(f"--- {label}: {dt:.1f}s ({len(reads)/dt:.0f} reads/s)", flush=True)
if passes < 2:
    out["cold"] = out["steady"]
    out["single_pass"] = True
out["stats"] = res.stats
# verify recovery against the simulated truth
from shannon_tpu.eval import evaluate
out["quality"] = evaluate(ts, [t.seq for t in res.transcripts], k=24)
out["n_reads"] = len(reads)
out["distinct_programs"] = len(programs.keys)
# ru_maxrss is KiB on Linux, bytes on macOS
_rss_div = 1024 * 1024 if sys.platform == "darwin" else 1024
out["peak_rss_mb"] = int(
    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // _rss_div
)
print(json.dumps(out))
