"""Proof that the assembler runs on an NVIDIA GPU through the entry
points a user calls, at a size users call real.

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --four    # the multi-GPU paths on four GPUs

Phases of the default run, all in this one process (a JAX process
reserves most of the card's memory, so a second one could not use it):

  1 device    JAX's backend is the GPU; the card's name and power limit
              from nvidia-smi; the native ingest library loads.
  2 parity    on a seeded 20k-read instance the device path equals the
              oracle exactly, stage by stage (corrected spectrum,
              contigs, transcripts up to reverse complement), and the
              device sparse-flow solver gives the host solver's pairings
              on every X-node; then the tests marked `gpu` run here.
  3 single    1M single-end reads through `shannon_tpu.cli.main`, cold
              and then warm; exact recall against the truth >= 0.95.
  4 paired    250k read pairs through --left/--right; recall >= 0.9.

`--four` runs only the paths that span cards and what they are
compared with:

  5 sharded       in this process, the phase-3 FASTA through `-p 4` and
                  `-p 1` gives the same transcript set, and
                  `dryrun_multichip(4)` passes.
  6 multiprocess  four child processes, one card each, joined through
                  jax.distributed, give the `-p 1` transcripts.

With `--four` this process takes FOUR_MEM_FRACTION of each card (unless
XLA_PYTHON_CLIENT_MEM_FRACTION is set), and so does each child, so the
children fit beside it.  Every process shares one compile cache
(utils/jaxcache.py).

A failed phase raises, so the script exits non-zero and prints no
result.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PHASES = ("device", "parity", "single", "paired")
FOUR_PHASES = ("sharded", "multiprocess")
SINGLE_READS = 1_000_000
SINGLE_MIN_RECALL = 0.95
PAIRED_PAIRS = 250_000
PAIRED_MIN_RECALL = 0.9  # ROADMAP B4: paired sampling is not yet a match
PARITY_READS = 20_000
FOUR_MEM_FRACTION = "0.3"
ON_DEVICE_TESTS_ENV = "SHANNON_TESTS_ON_DEVICE"


def select_phases(four: bool) -> tuple[str, ...]:
    return FOUR_PHASES if four else PHASES


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------
# phase 1


def phase_device() -> dict:
    """The GPU, the card, the native library."""
    import jax

    from shannon_tpu.native import load
    from shannon_tpu.utils.device import device_info, nvidia_smi

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX's default backend is {backend!r}, not gpu")
    info = device_info()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    raw, _rows = nvidia_smi()
    log(f"nvidia-smi: {raw}")
    log(f"native ingest: loaded {load()._name}")
    return info


# ---------------------------------------------------------------------
# phase 2


def phase_parity(
    n_reads: int = PARITY_READS,
    n_transcripts: int = 50,
    kmer_capacity: int = 1 << 22,
    seed: int = 3,
) -> dict:
    """Device path == oracle, stage by stage, exactly."""
    import numpy as np

    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.dna import encode_seq
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.oracle.correction import clip_tips
    from shannon_tpu.oracle.graph import build_contigs
    from shannon_tpu.oracle.multibridge import multibridge, thread_reads
    from shannon_tpu.oracle.nodegraph import NodeGraph
    from shannon_tpu.oracle.sparseflow import solve_node, sparse_flow
    from shannon_tpu.ops.sparseflow import solve_nodes_device
    from shannon_tpu.pipeline import (
        _graph_device,
        _spectrum_device,
        _spectrum_oracle,
        assemble,
    )
    from shannon_tpu.sim import simulate_expression

    _ts, reads = simulate_expression(
        np.random.default_rng(seed), n_reads, n_transcripts=n_transcripts
    )
    cfg = AssemblyConfig(k=24, kmer_capacity=kmer_capacity)
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)

    # every stage is compared before any failure is raised, so one run
    # says which stages differ
    differ: list[str] = []

    def compare(stage: str, got, want) -> None:
        same = got == want
        if isinstance(got, (set, frozenset)):
            detail = (f"{len(got)} vs {len(want)}, "
                      f"{len(got - want)} only on device")
        else:
            detail = f"{len(got)} vs {len(want)}"
        log(f"parity {stage}: {'equal' if same else 'DIFFER'} ({detail})")
        if not same:
            differ.append(stage)

    spec_dev, _ = _spectrum_device(batch, cfg, clip=False)
    alive = _spectrum_oracle(reads, cfg)
    compare("corrected spectrum", spec_dev.to_dict(), alive)

    cg_dev, _n, _ca = _graph_device(batch, cfg)
    cg_orc = build_contigs(clip_tips(alive, cfg), cfg)
    compare("contigs (sequence, abundance)",
            {(c.seq, c.abundance) for c in cg_dev.contigs},
            {(c.seq, c.abundance) for c in cg_orc.contigs})

    # sparse flow: every X-node of every round, device solver vs host
    sf = {"nodes": 0, "calls": 0, "differ": 0}

    def checking_solver(g, xs, config, flows=None):
        got = solve_nodes_device(g, xs, config, flows)
        for v in xs:
            if sorted(got[v]) != sorted(solve_node(g, v, config, flows)):
                sf["differ"] += 1
        sf["nodes"] += len(xs)
        sf["calls"] += 1
        return got

    paths, weights = thread_reads([encode_seq(s) for s in reads], cg_orc, cfg)
    g = NodeGraph.from_contig_graph(cg_orc, paths, weights)
    multibridge(g, cfg)
    sparse_flow(g, cfg, solver=checking_solver)
    log(f"parity sparse flow: {sf['differ']} of {sf['nodes']} X-nodes "
        f"differ over {sf['calls']} rounds")
    if sf["differ"]:
        differ.append("sparse flow pairings")

    dev = assemble(reads, cfg, backend="device")
    orc = assemble(reads, cfg, backend="oracle")
    compare("transcripts (up to reverse complement)",
            dev.canonical_set(), orc.canonical_set())
    if dev.stats != {**orc.stats, "backend": "device"}:
        log(f"parity stats: device {dev.stats} oracle {orc.stats}")
    check(not differ, f"device != oracle at: {', '.join(differ)}")
    check(len(dev.transcripts) > 0, "parity instance emitted no transcript")
    out = {
        "reads": len(reads),
        "kmers": len(alive),
        "contigs": len(cg_dev.contigs),
        "transcripts": len(dev.transcripts),
        "sf_x_nodes": sf["nodes"],
        "sf_rounds": sf["calls"],
    }
    log(f"parity: exact ({json.dumps(out)})")
    return out


class _Outcomes:
    """pytest plugin: counts the outcome of every test."""

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}

    def pytest_runtest_logreport(self, report) -> None:
        if report.when == "call" or report.outcome != "passed":
            n = self.counts.get(report.outcome, 0)
            self.counts[report.outcome] = n + 1


def run_card_tests() -> dict:
    """The tests marked `gpu`, in this process (conftest leaves the
    backend alone under ON_DEVICE_TESTS_ENV); every one must pass, none
    may skip."""
    import pytest

    os.environ[ON_DEVICE_TESTS_ENV] = "1"
    seen = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(REPO / "tests")],
        plugins=[seen],
    )
    log(f"card tests: {seen.counts}")
    check(rc == 0 and set(seen.counts) == {"passed"},
          f"card tests: pytest exit code {rc}, outcomes {seen.counts}")
    return seen.counts


# ---------------------------------------------------------------------
# phases 3 and 4


def _transcripts(out_dir: Path) -> list[str]:
    from shannon_tpu.io.fastx import read_fastx

    return [s for _h, s in read_fastx(out_dir / "transcripts.fasta")]


def _canonical(seqs: list[str]) -> set[str]:
    from shannon_tpu.io.dna import revcomp_str

    return {min(s, revcomp_str(s)) for s in seqs}


def write_single_fasta(work: Path, n_reads: int, n_transcripts: int = 500,
                       seed: int = 11):
    """The benchmark dataset as a FASTA file; returns (path, truth)."""
    import numpy as np

    from shannon_tpu.io.fastx import write_fasta
    from shannon_tpu.sim import simulate_expression

    ts, reads = simulate_expression(
        np.random.default_rng(seed), n_reads, n_transcripts=n_transcripts
    )
    fasta = work / "reads.fasta"
    write_fasta(fasta, ((f"r{i}", s) for i, s in enumerate(reads)))
    return fasta, ts


def _stage_split(out_dir: Path) -> dict:
    stats = json.loads((out_dir / "stats.json").read_text())
    return {
        name: {k: v for k, v in rec.items()
               if isinstance(v, (int, float)) and k.endswith("_s")}
        for name, rec in stats["stages"].items()
    }


def phase_single(work: Path, n_reads: int = SINGLE_READS,
                 min_recall: float = SINGLE_MIN_RECALL,
                 n_transcripts: int = 500,
                 cli_args: tuple[str, ...] = ()) -> dict:
    """Single-end reads through the CLI, cold then warm."""
    from shannon_tpu import cli
    from shannon_tpu.eval import evaluate
    from shannon_tpu.utils.device import peak_bytes_in_use

    t0 = time.perf_counter()
    fasta, truth = write_single_fasta(work, n_reads, n_transcripts)
    log(f"single: wrote {fasta} in {time.perf_counter() - t0:.2f} s")
    out = work / "single"
    walls = {}
    for label, extra in (("cold", []), ("warm", ["--no-resume"])):
        t0 = time.perf_counter()
        rc = cli.main(
            ["-o", str(out), "--single", str(fasta), *extra, *cli_args]
        )
        walls[label] = time.perf_counter() - t0
        check(rc == 0, f"single-end {label} run exited {rc}")
        if label == "cold":
            cold_set = _canonical(_transcripts(out))
    seqs = _transcripts(out)
    check(len(seqs) > 0, "single-end run emitted no transcript")
    check(_canonical(seqs) == cold_set, "warm transcripts != cold transcripts")
    q = evaluate(truth, seqs, k=24)
    res = {
        "reads": n_reads,
        "cold_wall_s": walls["cold"],
        "warm_wall_s": walls["warm"],
        "stages_warm": _stage_split(out),
        "peak_bytes_in_use": peak_bytes_in_use(),
        "recall_exact": q["recall_exact"],
        "precision": q["precision"],
        "n_transcripts": len(seqs),
    }
    log(f"single: {json.dumps(res)}")
    check(q["recall_exact"] >= min_recall,
          f"single-end exact recall {q['recall_exact']} < {min_recall}")
    return res


def phase_paired(work: Path, n_pairs: int = PAIRED_PAIRS,
                 min_recall: float = PAIRED_MIN_RECALL,
                 n_transcripts: int = 500,
                 cli_args: tuple[str, ...] = (), seed: int = 12) -> dict:
    """Paired reads through --left/--right."""
    import numpy as np

    from shannon_tpu import cli
    from shannon_tpu.eval import evaluate
    from shannon_tpu.io.fastx import write_fasta
    from shannon_tpu.sim import simulate_expression

    truth, reads = simulate_expression(
        np.random.default_rng(seed), n_pairs, n_transcripts=n_transcripts,
        paired=True, insert_size=300,
    )
    left, right = work / "left.fasta", work / "right.fasta"
    write_fasta(left, ((f"p{i}/1", s) for i, s in enumerate(reads[0::2])))
    write_fasta(right, ((f"p{i}/2", s) for i, s in enumerate(reads[1::2])))
    out = work / "paired"
    t0 = time.perf_counter()
    rc = cli.main(["-o", str(out), "--left", str(left), "--right",
                   str(right), *cli_args])
    wall = time.perf_counter() - t0
    check(rc == 0, f"paired run exited {rc}")
    seqs = _transcripts(out)
    check(len(seqs) > 0, "paired run emitted no transcript")
    q = evaluate(truth, seqs, k=24)
    res = {
        "pairs": len(reads) // 2,
        "wall_s": wall,
        "recall_exact": q["recall_exact"],
        "precision": q["precision"],
        "n_transcripts": len(seqs),
    }
    log(f"paired: {json.dumps(res)}")
    check(q["recall_exact"] >= min_recall,
          f"paired exact recall {q['recall_exact']} < {min_recall}")
    return res


# ---------------------------------------------------------------------
# --four: phase 5 in this process, phase 6 in child processes


def _run_child(cmd: list[str], timeout: float = 900) -> str:
    """Run one child to its end; raise with its output when it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    log(f"  {' '.join(cmd[1:])}: rc={proc.returncode} "
        f"in {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        raise RuntimeError(
            f"child {cmd} exited {proc.returncode}\n"
            f"--- stdout ---\n{proc.stdout[-8000:]}\n"
            f"--- stderr ---\n{proc.stderr[-8000:]}"
        )
    return proc.stdout


def phase_sharded(work: Path, fasta: Path, n_devices: int = 4,
                  cli_args: tuple[str, ...] = ()) -> dict:
    """-p N == -p 1 on one FASTA, both through the CLI in this process."""
    from shannon_tpu import cli

    sets, walls = {}, {}
    for p in (n_devices, 1):
        out = work / f"p{p}"
        t0 = time.perf_counter()
        rc = cli.main(["-o", str(out), "--single", str(fasta), "-p", str(p),
                       *cli_args])
        walls[p] = time.perf_counter() - t0
        check(rc == 0, f"-p {p} run exited {rc}")
        sets[p] = _canonical(_transcripts(out))
    check(len(sets[1]) > 0, "-p 1 emitted no transcript")
    check(sets[n_devices] == sets[1],
          f"-p {n_devices} transcripts != -p 1 transcripts "
          f"({len(sets[n_devices])} vs {len(sets[1])})")
    res = {"n_transcripts": len(sets[1]),
           **{f"p{p}_wall_s": w for p, w in walls.items()}}
    log(f"sharded: -p {n_devices} == -p 1 ({json.dumps(res)})")
    return res


def phase_multiprocess(work: Path, fasta: Path, n_procs: int = 4,
                       platform: str = "gpu") -> None:
    """n_procs processes, one device each, == the -p 1 transcripts."""
    expected = work / "p1" / "transcripts.fasta"
    check(expected.exists(), "phase sharded must run first (-p 1 output)")
    _run_child([
        sys.executable, str(REPO / "scripts" / "multihost_smoke.py"),
        "--platform", platform, "--procs", str(n_procs),
        "--fasta", str(fasta), "--expected", str(expected),
        "--work", str(work / "multiprocess"),
    ])
    log(f"multiprocess: {n_procs} processes == single-process transcripts")


# ---------------------------------------------------------------------


def _run_device(work: Path, state: dict) -> None:
    from shannon_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    state["device"] = phase_device()


def _run_parity(work: Path, state: dict) -> None:
    phase_parity()
    run_card_tests()


def _run_single(work: Path, state: dict) -> None:
    phase_single(work)


def _run_paired(work: Path, state: dict) -> None:
    phase_paired(work)


def _run_sharded(work: Path, state: dict) -> None:
    import __graft_entry__
    from shannon_tpu.native import load
    from shannon_tpu.utils.device import device_info, nvidia_smi
    from shannon_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    info = device_info()
    check(info["platform"] == "gpu" and info["count"] == 4,
          f"--four needs four GPUs, found {info}")
    log(f"devices: {info}")
    log(f"nvidia-smi: {nvidia_smi()[0]}")
    log(f"native ingest: loaded {load()._name}")
    t0 = time.perf_counter()
    fasta, _truth = write_single_fasta(work, SINGLE_READS)
    log(f"wrote {fasta} in {time.perf_counter() - t0:.2f} s")
    phase_sharded(work, fasta)
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"dryrun_multichip(4): ok in {time.perf_counter() - t0:.2f} s")
    state.update(device=info, fasta=fasta)


def _run_multiprocess(work: Path, state: dict) -> None:
    phase_multiprocess(work, state["fasta"])


RUNNERS = {
    "device": _run_device,
    "parity": _run_parity,
    "single": _run_single,
    "paired": _run_paired,
    "sharded": _run_sharded,
    "multiprocess": _run_multiprocess,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phases")
    args = ap.parse_args(argv)
    phases = select_phases(args.four)
    if args.four:
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION",
                              FOUR_MEM_FRACTION)
    log(f"phases: {', '.join(phases)}")
    t_all = time.perf_counter()
    state: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in phases:
            t0 = time.perf_counter()
            RUNNERS[name](Path(tmp), state)
            log(f"phase {name}: done in {time.perf_counter() - t0:.2f} s")
    log(f"total: {time.perf_counter() - t_all:.2f} s")
    from shannon_tpu.utils.device import nvidia_smi

    log(f"card: {nvidia_smi()[0]}")
    print(json.dumps({"ok": True, "device": state["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
