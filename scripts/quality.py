"""Regenerate the committed quality artifacts (QUALITY.md + quality.json).

Three regenerable sections, each one command (any backend, CPU or GPU —
output is backend-independent by the parity contract):

  PYTHONPATH=. python scripts/quality.py                    # pinned midscale
  PYTHONPATH=. python scripts/quality.py --paired-bridging  # pairs on/off
  PYTHONPATH=. python scripts/quality.py --sweep            # sensitivity

quality.json accumulates the sections; QUALITY.md is re-rendered from
all sections present.  Tracked so quality regressions are visible in
review.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SEED = 1234
N_TRANSCRIPTS = 100
T_LEN = 1500
COVERAGE = 20.0
READ_LEN = 100
ERROR_RATE = 0.01

# --paired-bridging: repeats longer than a read, shorter than the insert
PB_SEED = 4321
PB_N_PAIRS = 10
PB_REPEAT = 180
PB_FLANK = 400
PB_INSERT = 300

SWEEP_COVERAGES = (5.0, 10.0, 20.0)
SWEEP_CUTOFFS = (0.0, 1.0, 1.5)  # 1.0 = default (re-chosen from this sweep)


def _load() -> dict:
    p = REPO / "quality.json"
    if p.exists():
        data = json.loads(p.read_text())
        if "pinned" in data or "paired_bridging" in data or "sweep" in data:
            return data
        return {"pinned": data}  # pre-r3 single-section format
    return {}


def _pinned_dataset(coverage: float):
    from shannon_tpu.sim import sample_reads, simulate_transcripts

    rng = np.random.default_rng(SEED)
    abund = np.exp(rng.normal(0, 1, N_TRANSCRIPTS))
    abund = (abund / abund.mean()).tolist()
    truth = simulate_transcripts(rng, n=N_TRANSCRIPTS, length=T_LEN)
    reads = sample_reads(
        rng, truth, abundances=abund, coverage=coverage,
        read_length=READ_LEN, error_rate=ERROR_RATE,
    )
    return truth, reads


def run_pinned(backend: str) -> dict:
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.eval import evaluate
    from shannon_tpu.pipeline import assemble

    truth, reads = _pinned_dataset(COVERAGE)
    cfg = AssemblyConfig(kmer_capacity=1 << 20)
    t0 = time.perf_counter()
    res = assemble(reads, cfg, backend=backend)
    wall = time.perf_counter() - t0
    metrics = evaluate(truth, [t.seq for t in res.transcripts], k=cfg.k)
    return {
        "dataset": {
            "seed": SEED,
            "n_transcripts": N_TRANSCRIPTS,
            "transcript_length": T_LEN,
            "coverage_mean": COVERAGE,
            "read_length": READ_LEN,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "abundances": "log-normal(0, 1), mean-normalized",
        },
        "backend": backend,
        "wall_s": round(wall, 1),
        "metrics": metrics,
        "assembly_stats": res.stats,
    }


def run_paired_bridging(backend: str) -> dict:
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.eval import evaluate
    from shannon_tpu.pipeline import assemble
    from shannon_tpu.sim import sample_paired_reads, simulate_repeat_transcripts

    rng = np.random.default_rng(PB_SEED)
    truth = simulate_repeat_transcripts(
        rng, n_pairs=PB_N_PAIRS, repeat_length=PB_REPEAT,
        flank_length=PB_FLANK,
    )
    reads = sample_paired_reads(
        rng, truth, coverage=COVERAGE, read_length=READ_LEN,
        insert_size=PB_INSERT, error_rate=ERROR_RATE,
    )
    cfg = AssemblyConfig(kmer_capacity=1 << 20)
    out: dict = {
        "dataset": {
            "seed": PB_SEED,
            "n_repeat_pairs": PB_N_PAIRS,
            "repeat_length": PB_REPEAT,
            "flank_length": PB_FLANK,
            "insert_size": PB_INSERT,
            "read_length": READ_LEN,
            "coverage": COVERAGE,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "shape": "t_2i = A_i+R_i+B_i, t_2i+1 = C_i+R_i+D_i; "
                     "equal abundance (SF flow-degenerate at each repeat)",
        },
        "backend": backend,
    }
    for use_pairs in (False, True):
        t0 = time.perf_counter()
        res = assemble(
            reads, replace(cfg, use_pairs=use_pairs), backend=backend,
            paired=True,
        )
        m = evaluate(truth, [t.seq for t in res.transcripts], k=cfg.k)
        m["wall_s"] = round(time.perf_counter() - t0, 1)
        out["pairs_on" if use_pairs else "pairs_off"] = m
    return out


SG_SEED = 99
SG_GENES = 30
SG_COVERAGE = 20.0


def run_splicing(backend: str) -> dict:
    """Splicing-graph quality gate: genes = exon
    chains, isoforms = exon subsets sharing sequence, log-normal
    per-isoform abundances.  Reports exact/partial recall and precision
    overall AND per abundance decile, plus the SF/MB split counts
    actually exercised — the i.i.d. random-transcript sims let SF
    resolve nothing (0 splits at 4M reads), so this is the gate that
    exercises the algorithmic core."""
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.eval import evaluate
    from shannon_tpu.io.dna import revcomp_str
    from shannon_tpu.pipeline import assemble
    from shannon_tpu.sim import sample_reads, simulate_gene_isoforms

    rng = np.random.default_rng(SG_SEED)
    truth, gene_of = simulate_gene_isoforms(rng, n_genes=SG_GENES)
    abund = np.exp(rng.normal(0, 1, len(truth)))
    abund = (abund / abund.mean()).tolist()
    reads = sample_reads(
        rng, truth, abundances=abund, coverage=SG_COVERAGE,
        read_length=READ_LEN, error_rate=ERROR_RATE,
    )
    cfg = AssemblyConfig(kmer_capacity=1 << 20)
    t0 = time.perf_counter()
    res = assemble(reads, cfg, backend=backend)
    wall = time.perf_counter() - t0
    seqs = [t.seq for t in res.transcripts]
    m = evaluate(truth, seqs, k=cfg.k)

    # per-abundance-decile exact recall (which expression levels lose)
    asm_canon = {min(s, revcomp_str(s)) for s in seqs}
    order = np.argsort(abund)
    deciles = []
    for d in range(10):
        sel = order[d * len(truth) // 10 : (d + 1) * len(truth) // 10]
        if not len(sel):
            continue
        hit = sum(
            1
            for i in sel
            if min(truth[i], revcomp_str(truth[i])) in asm_canon
        )
        deciles.append(
            {
                "decile": d,
                "abundance_range": [
                    round(float(abund[sel[0]]), 3),
                    round(float(abund[sel[-1]]), 3),
                ],
                "n": int(len(sel)),
                "exact": hit,
            }
        )
    # paired-end variant on the SAME transcriptome: shared exons longer
    # than a read leave no single-read (a, v, b) triple to witness, so
    # their nodes are locally ambiguous — mate bridging is the designed
    # resolver (SURVEY.md §6 'long context').  Isoforms shorter than
    # the insert are unsampled by the paired sim (noted, not an
    # assembler property).
    from shannon_tpu.sim import sample_paired_reads

    rng_p = np.random.default_rng(SG_SEED + 1)
    insert = 350
    preads = sample_paired_reads(
        rng_p, truth, abundances=abund, coverage=SG_COVERAGE,
        read_length=READ_LEN, insert_size=insert, error_rate=ERROR_RATE,
    )
    res_p = assemble(preads, cfg, backend=backend, paired=True)
    m_p = evaluate(truth, [t.seq for t in res_p.transcripts], k=cfg.k)
    m_p["n_isoforms_below_insert"] = sum(
        1 for t in truth if len(t) < insert
    )

    return {
        "dataset": {
            "seed": SG_SEED,
            "n_genes": SG_GENES,
            "n_isoforms": len(truth),
            "coverage_mean": SG_COVERAGE,
            "read_length": READ_LEN,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "abundances": "log-normal(0, 1) per isoform, mean-normalized",
            "shape": "genes = exon chains; isoforms = order-preserving "
            "exon subsets anchored at terminal exons (shared-exon "
            "structure -> SF flow decomposition is exercised)",
        },
        "backend": backend,
        "wall_s": round(wall, 1),
        "metrics": m,
        "metrics_paired": m_p,
        "paired_insert_size": insert,
        "per_abundance_decile": deciles,
        "assembly_stats": res.stats,
        "assembly_stats_paired": {
            k2: res_p.stats[k2]
            for k2 in ("n_mb_splits", "n_sf_splits", "n_transcripts")
        },
    }


def run_sweep(backend: str) -> dict:
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.eval import evaluate
    from shannon_tpu.pipeline import assemble

    rows = []
    for cov in SWEEP_COVERAGES:
        truth, reads = _pinned_dataset(cov)
        # assemble once with cutoff 0; higher cutoffs are exactly the
        # per-transcript output filter re-applied (dedupe_and_filter
        # keeps the max-abundance representative per canonical key, so
        # post-filtering the cutoff-0 output equals assembling at that
        # cutoff — oracle/assemble.py dedupe_and_filter)
        cfg = AssemblyConfig(kmer_capacity=1 << 20, min_output_abundance=0.0)
        res = assemble(reads, cfg, backend=backend)
        for cut in SWEEP_CUTOFFS:
            seqs = [
                t.seq for t in res.transcripts
                if np.float32(t.abundance) >= np.float32(cut)
            ]
            m = evaluate(truth, seqs, k=cfg.k)
            rows.append(
                {"coverage": cov, "min_output_abundance": cut,
                 "n_reads": len(reads), **m}
            )
            print(json.dumps(rows[-1]), flush=True)
    return {"backend": backend, "rows": rows}


def render(data: dict) -> str:
    md = [
        "# Quality — pinned midscale simulation",
        "",
        "Regenerate any section with one command (see header of"
        " `scripts/quality.py`); output is backend-independent by the"
        " parity contract.",
        "",
    ]
    if "pinned" in data:
        p = data["pinned"]
        d, m = p["dataset"], p["metrics"]
        s = p["assembly_stats"]
        md += [
            f"**Dataset (pinned):** seed {d['seed']}, "
            f"{d['n_transcripts']} random transcripts x "
            f"{d['transcript_length']}bp, log-normal abundances, "
            f"{d['coverage_mean']:.0f}x mean coverage, "
            f"{d['read_length']}bp single-end reads, "
            f"{d['error_rate']:.0%} error rate -> {d['n_reads']} reads.",
            "",
            "**Metrics** (shannon_tpu.eval: exact = transcript recovered"
            " verbatim up to RC; partial = >=95% of its k-mers present;"
            " precision = assembled transcripts matching truth):",
            "",
            "| metric | value |",
            "|---|---|",
            f"| recall (exact) | {m['recall_exact']:.1%} |",
            f"| recall (exact + partial) | {m['recall_partial']:.1%} |",
            f"| precision | {m['precision']:.1%} |",
            f"| transcripts assembled | {m['n_assembled']} |",
            f"| truth transcripts | {m['n_truth']} |",
            "",
            f"Assembly stats: {s['n_kmers_final']} corrected k-mers, "
            f"{s['n_contigs']} contigs, {s['n_components']} components, "
            f"{s['n_mb_splits']} MB splits, {s['n_sf_splits']} SF splits.",
            "",
        ]
    if "paired_bridging" in data:
        p = data["paired_bridging"]
        d = p["dataset"]
        off, on = p["pairs_off"], p["pairs_on"]
        md += [
            "## Paired-end bridging (repeat-bearing dataset)",
            "",
            f"Seed {d['seed']}: {d['n_repeat_pairs']} transcript pairs, "
            f"each pair sharing a distinct {d['repeat_length']}bp repeat "
            f"(> {d['read_length']}bp read, < {d['insert_size']}bp "
            f"insert) between {d['flank_length']}bp unique flanks; equal "
            f"abundances make every repeat X-node flow-degenerate, so "
            f"single reads cannot phase it — mates spanning the repeat "
            f"can.  {d['n_reads']} paired reads at "
            f"{d['coverage']:.0f}x, {d['error_rate']:.0%} error.",
            "",
            "| config | recall (exact) | recall (partial) | precision |",
            "|---|---|---|---|",
            f"| use_pairs=False | {off['recall_exact']:.1%} |"
            f" {off['recall_partial']:.1%} | {off['precision']:.1%} |",
            f"| use_pairs=True | {on['recall_exact']:.1%} |"
            f" {on['recall_partial']:.1%} | {on['precision']:.1%} |",
            "",
        ]
    if "splicing" in data:
        p = data["splicing"]
        d, m, s = p["dataset"], p["metrics"], p["assembly_stats"]
        md += [
            "## Splicing-graph isoform recovery (the SF gate)",
            "",
            f"Seed {d['seed']}: {d['n_genes']} genes as exon chains, "
            f"{d['n_isoforms']} isoforms as order-preserving exon "
            f"subsets anchored at terminal exons (isoforms of one gene "
            f"share exon sequence — the structure sparse flow exists "
            f"for), log-normal per-isoform abundances, "
            f"{d['coverage_mean']:.0f}x mean coverage, "
            f"{d['error_rate']:.0%} error -> {d['n_reads']} reads.",
            "",
            "| metric | value |",
            "|---|---|",
            f"| recall (exact) | {m['recall_exact']:.1%} |",
            f"| recall (exact + partial) | {m['recall_partial']:.1%} |",
            f"| precision | {m['precision']:.1%} |",
            f"| transcripts assembled | {m['n_assembled']} |",
            f"| true isoforms | {m['n_truth']} |",
            f"| MB splits | {s['n_mb_splits']} |",
            f"| **SF splits exercised** | **{s['n_sf_splits']}** |",
            "",
        ]
        if "metrics_paired" in p:
            mp = p["metrics_paired"]
            md += [
                f"Paired-end variant (insert {p['paired_insert_size']}bp,"
                " same transcriptome): exact recall "
                f"**{mp['recall_exact']:.1%}**, partial "
                f"{mp['recall_partial']:.1%}, precision "
                f"{mp['precision']:.1%} — shared exons longer than a"
                " read leave no single-read evidence triple, so their"
                " nodes are locally ambiguous; mate bridging resolves"
                f" them.  ({mp['n_isoforms_below_insert']} isoforms are"
                " shorter than the insert and unsampled by the paired"
                " sim.)",
                "",
            ]
        md += [
            "Exact recall per abundance decile (low -> high expression):",
            "",
            "| decile | abundance | n | exact |",
            "|---|---|---|---|",
        ]
        for r in p["per_abundance_decile"]:
            md.append(
                f"| {r['decile']} | {r['abundance_range'][0]:.2f}-"
                f"{r['abundance_range'][1]:.2f} | {r['n']} | "
                f"{r['exact']}/{r['n']} |"
            )
        md.append("")
    if "sweep" in data:
        md += [
            "## Sensitivity: coverage x min_output_abundance",
            "",
            "Pinned dataset resampled at each coverage; one assembly per"
            " coverage (cutoff 0), higher cutoffs re-apply the output"
            " filter (exact — the cutoff is a pure per-transcript output"
            " filter).",
            "",
            "| coverage | cutoff | recall (exact) | recall (partial) |"
            " precision | assembled |",
            "|---|---|---|---|---|---|",
        ]
        for r in data["sweep"]["rows"]:
            md.append(
                f"| {r['coverage']:.0f}x | {r['min_output_abundance']} |"
                f" {r['recall_exact']:.1%} | {r['recall_partial']:.1%} |"
                f" {r['precision']:.1%} | {r['n_assembled']} |"
            )
        md.append("")
    md += [
        "*(timings are informational only; BENCH_r*.json carries the"
        " performance numbers)*",
        "",
    ]
    return "\n".join(md)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="device",
                    choices=["device", "oracle"])
    ap.add_argument("--paired-bridging", action="store_true")
    ap.add_argument("--splicing", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    data = _load()
    if args.paired_bridging:
        data["paired_bridging"] = run_paired_bridging(args.backend)
        print(json.dumps(data["paired_bridging"], indent=2))
    elif args.splicing:
        data["splicing"] = run_splicing(args.backend)
        print(json.dumps(data["splicing"], indent=2))
    elif args.sweep:
        data["sweep"] = run_sweep(args.backend)
    else:
        data["pinned"] = run_pinned(args.backend)
        print(json.dumps(data["pinned"]["metrics"]))
    (REPO / "quality.json").write_text(json.dumps(data, indent=2) + "\n")
    (REPO / "QUALITY.md").write_text(render(data))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
