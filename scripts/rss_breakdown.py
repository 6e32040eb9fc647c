"""RSS breakdown of an end-to-end assembly: the 100M-read ceiling has no
memory story without it.

Runs the device pipeline at a given read count, sampling resident-set
size at every stage boundary AND computing the analytic size of each
major resident structure, so the delta-RSS column can be attributed:

  python scripts/rss_breakdown.py [n_reads] [out.json]

Prints one JSON document: per-stage current/delta RSS plus the
analytic bytes of reads, packed codes, spectrum checkpoints, contig
strings, evidence arrays, and NodeGraph objects.  Companion design
note: docs/SCALING.md.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from shannon_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()


def rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for ln in fh:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 1024.0
    return -1.0


def deep_list_bytes(strings: list[str]) -> int:
    """Approximate resident bytes of a list of str (list slots +
    object headers + character payloads)."""
    return 8 * len(strings) + sum(49 + len(s) for s in strings)


def main() -> None:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
    out_path = sys.argv[2] if len(sys.argv) > 2 else None
    samples: list[dict] = []
    t_start = time.perf_counter()

    def mark(stage: str, **extra) -> None:
        cur = rss_mb()
        prev = samples[-1]["rss_mb"] if samples else 0.0
        samples.append(
            {
                "stage": stage,
                "rss_mb": round(cur, 1),
                "delta_mb": round(cur - prev, 1),
                "t_s": round(time.perf_counter() - t_start, 1),
                **extra,
            }
        )
        print(json.dumps(samples[-1]), flush=True)

    mark("interpreter")
    import jax  # noqa: F401

    jax.devices()
    mark("jax_initialized")

    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.sim import sample_reads, simulate_transcripts

    rng = np.random.default_rng(11)
    n_tr, tlen = 500, 1500
    ts = simulate_transcripts(rng, n=n_tr, length=tlen)
    abund = np.exp(rng.normal(0, 1, n_tr))
    reads = sample_reads(
        rng, ts, abundances=(abund / abund.mean()).tolist(),
        coverage=n_reads * 100 / (n_tr * tlen), read_length=100,
        error_rate=0.01,
    )
    mark(
        "reads_simulated",
        n_reads=len(reads),
        analytic_reads_mb=round(deep_list_bytes(reads) / 2**20, 1),
    )

    from shannon_tpu.io.pack import pack_reads

    cfg = AssemblyConfig()
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    mark(
        "packed",
        # packed-resident (round 5): the resident structure is the 2-bit
        # word matrix; the uint8 code matrix no longer exists
        analytic_words_mb=round(batch.words.nbytes / 2**20, 1),
    )

    from shannon_tpu.pipeline import _graph_device, _thread_device

    cgraph, n_alive, ca = _graph_device(batch, cfg)
    seq_bytes = deep_list_bytes([c.seq for c in cgraph.contigs])
    mark(
        "spectrum+graph",
        n_kmers=n_alive,
        n_contigs=cgraph.n,
        analytic_contig_strings_mb=round(seq_bytes / 2**20, 1),
        analytic_device_tables_mb=round(
            sum(
                int(np.prod(a.shape)) * a.dtype.itemsize
                for a in jax.tree_util.tree_leaves(ca)
            )
            / 2**20,
            1,
        ),
    )

    from shannon_tpu.parallel.components import device_components

    comps = device_components(ca)
    mark("partition", n_components=len(comps))

    evidence = _thread_device(batch, ca, cgraph, cfg)
    flat, offs, weights = evidence
    mark(
        "threading",
        n_paths=len(weights),
        analytic_evidence_mb=round(
            (flat.nbytes + offs.nbytes + weights.nbytes) / 2**20, 1
        ),
    )

    from shannon_tpu.oracle.nodegraph import NodeGraph

    g = NodeGraph.from_contig_graph(cgraph)
    g.set_paths_flat(*evidence)
    # Node object cost: ~56B object header + lists; sample-measure
    mark(
        "nodegraph",
        n_nodes=len(g.nodes),
        analytic_paths_mb=round(
            (g._flat.nbytes + g._offs.nbytes + g._weights.nbytes) / 2**20,
            1,
        ),
    )

    from shannon_tpu.oracle.assemble import dedupe_and_filter
    from shannon_tpu.parallel.components import assemble_components
    from shannon_tpu.pipeline import _sf_solver

    transcripts, n_mb, n_sf, truncated, phase_s = assemble_components(
        g, comps, cfg, solver=_sf_solver("device")
    )
    final = dedupe_and_filter(transcripts, cfg)
    mark("assembly", n_transcripts=len(final))

    import resource

    doc = {
        "n_reads": n_reads,
        "peak_rss_mb": int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
        ),
        "samples": samples,
    }
    print(json.dumps(doc))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")


if __name__ == "__main__":
    main()
