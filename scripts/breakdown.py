"""Fine-grained per-phase timing of the device assembly path.

Runs TWO passes in one process: pass 1 pays the compiles, pass 2 is
the steady-state production number.  Usage:

    PYTHONPATH=. python scripts/breakdown.py [n_reads]
"""
import sys, time
import numpy as np
from shannon_tpu.utils.jaxcache import enable_compilation_cache
enable_compilation_cache()
import jax, jax.numpy as jnp

from shannon_tpu.sim import simulate_transcripts, sample_reads
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.config import AssemblyConfig
from shannon_tpu.ops.count import count_reads_spectrum, shrink_spectrum
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.tipclip import clip_tips_spectrum
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.pipeline import _thread_device, _sf_solver
from shannon_tpu.oracle.nodegraph import NodeGraph
from shannon_tpu.oracle.multibridge import multibridge
from shannon_tpu.oracle.sparseflow import sparse_flow
from shannon_tpu.oracle.assemble import enumerate_transcripts, dedupe_and_filter
from shannon_tpu.utils.timing import StageTimer

n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 50000
rng = np.random.default_rng(11)
n_tr, tlen = 500, 1500
cov = n_reads * 100 / (n_tr * tlen)
abund = np.exp(rng.normal(0, 1, n_tr)); abund = (abund/abund.mean()).tolist()
ts = simulate_transcripts(rng, n=n_tr, length=tlen)
reads = sample_reads(rng, ts, abundances=abund, coverage=cov, read_length=100, error_rate=0.01)
cfg = AssemblyConfig()
print(f"{len(reads)} reads", flush=True)

for pass_name in ("cold", "steady"):
    print(f"--- pass: {pass_name} ---", flush=True)
    t0 = time.perf_counter(); start = t0
    def tick(name, t0):
        t = time.perf_counter()
        print(f"{name:28s} {t - t0:8.2f}s", flush=True)
        return t
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    t0 = tick("pack", t0)
    spec = count_reads_spectrum(batch.codes, batch.lengths, k=cfg.k, capacity=cfg.kmer_capacity)
    print(f"  raw distinct kmers: {int(spec.n)} cap {spec.capacity}", flush=True)
    t0 = tick("count", t0)
    spec = shrink_spectrum(spec)
    t0 = tick("shrink", t0)
    spec = correct_spectrum(spec, cfg.k, cfg.min_abundance, cfg.sibling_ratio, cfg.correction_rounds, error_rate=cfg.error_rate)
    print(f"  corrected kmers: {int(spec.n)} cap {spec.capacity}", flush=True)
    t0 = tick("correct", t0)
    timer = StageTimer(echo=False)
    spec = clip_tips_spectrum(spec, cfg, canonical=True)
    print(f"  clipped kmers: {int(spec.n)} cap {spec.capacity}", flush=True)
    t0 = tick("tipclip", t0)
    ca = build_contig_arrays(spec, cfg.k, canonical=True)
    print(f"  contigs: {int(ca.n_contigs)}", flush=True)
    t0 = tick("condense(build_ca)", t0)
    cgraph = to_contig_graph(ca, cfg.k, cfg)
    t0 = tick("to_contig_graph(host)", t0)
    evidence = _thread_device(batch, ca, cgraph, cfg, timer=timer)
    print(f"  thread notes: {timer.stages.get('threading')}", flush=True)
    t0 = tick("threading", t0)
    g = NodeGraph.from_contig_graph(cgraph)
    g.set_paths_flat(*evidence)
    t0 = tick("nodegraph-build", t0)
    n_mb = multibridge(g, cfg)
    t0 = tick(f"multibridge({n_mb})", t0)
    n_sf = sparse_flow(g, cfg, solver=_sf_solver("device"))
    t0 = tick(f"sparseflow({n_sf})", t0)
    transcripts, truncated = enumerate_transcripts(g, cfg)
    t0 = tick(f"enumerate({len(transcripts)})", t0)
    final = dedupe_and_filter(transcripts, cfg)
    t0 = tick(f"dedupe({len(final)})", t0)
    print(f"TOTAL {time.perf_counter()-start:.2f}s  reads/s={len(reads)/(time.perf_counter()-start):.0f}", flush=True)
