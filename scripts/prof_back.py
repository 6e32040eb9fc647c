"""Profile the assembly back-half (MB + SF + enumeration) at bench
scale: cProfile over assemble_components after a device front half.
Usage: PYTHONPATH=. python scripts/prof_back.py [n_reads]
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time

import numpy as np

from shannon_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.oracle.nodegraph import NodeGraph
from shannon_tpu.parallel.components import (
    assemble_components,
    device_components,
)
from shannon_tpu.pipeline import _graph_device, _sf_solver, _thread_device

N_READS = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
READ_LEN = 100


def main():
    rng = np.random.default_rng(11)
    from shannon_tpu.sim import sample_reads, simulate_transcripts

    n_tr, tlen = 500, 1500
    cov = N_READS * READ_LEN / (n_tr * tlen)
    abund = np.exp(rng.normal(0, 1, n_tr))
    ts = simulate_transcripts(rng, n=n_tr, length=tlen)
    reads = sample_reads(
        rng, ts, abundances=(abund / abund.mean()).tolist(), coverage=cov,
        read_length=READ_LEN, error_rate=0.01,
    )
    cfg = AssemblyConfig()
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    t0 = time.perf_counter()
    cgraph, n_alive, ca = _graph_device(batch, cfg)
    print(f"front half: {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    comps = device_components(ca)
    evidence = _thread_device(batch, ca, cgraph, cfg)
    print(f"threading: {time.perf_counter()-t0:.1f}s")

    g = NodeGraph.from_contig_graph(cgraph)
    g.set_paths_flat(*evidence)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    transcripts, n_mb, n_sf, truncated, phase_s = assemble_components(
        g, comps, cfg, solver=_sf_solver("device")
    )
    prof.disable()
    print(f"back half: {time.perf_counter()-t0:.1f}s  phases: {phase_s}")
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(35)


if __name__ == "__main__":
    main()
