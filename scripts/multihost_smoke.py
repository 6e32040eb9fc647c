"""Multi-process `jax.distributed` smoke test: the full pipeline,
FASTA to FASTA, with one device per process.

Each child process:

  * `init_distributed` runs `jax.distributed.initialize` (coordinator
    env vars set by the parent);
  * byte-range-ingests ITS 1/N of one FASTA (`host_byte_range` +
    `native.pack_file_range` — a record belongs to the range holding
    its header byte, so every read lands on exactly one process);
  * with an expected spectrum: runs the sharded count over the
    N-process global mesh and asserts the replicated merged spectrum
    equals it;
  * runs the FULL `run_pipeline` in each back-half mode asked for —
    'ownership' (evidence routed to component owners with one
    all_to_all, each host assembles only owned components, transcripts
    union-gathered) and 'replicate' (all-gather everything) — asserting
    transcript-set parity (up to RC) with the expected set; process 0's
    written transcripts.fasta is checked by the parent too.

    python scripts/multihost_smoke.py
        CPU: simulates a small dataset, expects the single-process
        oracle's spectrum and transcripts, runs a 2-process group (both
        modes) then a 4-process group (ownership), and writes the result
        JSON to $SMOKE_RESULT (default: multihost_smoke.json in the
        working directory).
    python scripts/multihost_smoke.py --platform gpu --procs 4 \
            --fasta reads.fasta --expected p1/transcripts.fasta --work DIR
        GPU: one card per process (CUDA_VISIBLE_DEVICES), ownership
        mode, at the default capacity and the FASTA's auto read pad;
        expects the transcript set of a single-process run's FASTA.
        Each child must report that NCCL carried its collectives.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
K = 24
PAD = 64  # explicit pad: multi-host ingest requires pinned shapes


def child() -> None:
    from shannon_tpu.parallel.multihost import host_byte_range, init_distributed
    from shannon_tpu.utils.jaxcache import enable_compilation_cache

    ok = init_distributed()
    enable_compilation_cache()  # one cache for every process of the group
    import jax

    assert ok, "init_distributed did not go multi-process"
    n_expected = int(os.environ["JAX_NUM_PROCESSES"])
    assert jax.process_count() == n_expected, jax.process_count()
    pid = jax.process_index()

    from shannon_tpu.native import pack_file_range

    fasta = os.environ["SMOKE_FASTA"]
    pad = int(os.environ["SMOKE_PAD"])
    capacity = int(os.environ["SMOKE_CAPACITY"])
    lo, hi = host_byte_range(fasta)
    n_local = pack_file_range(fasta, lo, hi, pad_length=pad).n_reads
    n = None
    if os.environ.get("SMOKE_EXPECTED"):
        n = _check_sharded_spectrum(fasta, lo, hi, pad, capacity, pid)

    # ---- phase 2: FULL pipeline, FASTA to FASTA, both back-half modes
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.dna import revcomp_str
    from shannon_tpu.pipeline import run_pipeline

    exp_t = set(
        json.loads(Path(os.environ["SMOKE_EXPECTED_T"]).read_text())
    )
    n_t = {}
    for mode in os.environ["SMOKE_MODES"].split(","):
        out_dir = Path(os.environ["SMOKE_OUT"]) / f"pipeline_{mode}"
        cfg = AssemblyConfig(
            k=K,
            kmer_capacity=capacity,
            out_dir=str(out_dir),
            read_pad_length=pad,
            multihost_backhalf=mode,
        )
        res = run_pipeline(cfg, single=fasta, backend="device")
        got = {min(t.seq, revcomp_str(t.seq)) for t in res.transcripts}
        assert got == exp_t, (
            f"proc {pid} mode {mode}: transcript set != single-process "
            f"oracle ({len(got)} vs {len(exp_t)}; "
            f"missing {len(exp_t - got)}, extra {len(got - exp_t)})"
        )
        n_t[mode] = len(res.transcripts)

    Path(os.environ["SMOKE_OUT"], f"ok{pid}.json").write_text(
        json.dumps(
            {
                "process": pid,
                "n_processes": jax.process_count(),
                "local_reads": int(n_local),
                "byte_range": [int(lo), int(hi)],
                "n_kmers": n,
                "platform": jax.devices()[0].platform,
                "n_transcripts": n_t["ownership"],
                "n_transcripts_by_mode": n_t,
            }
        )
    )
    print(
        f"child {pid}/{jax.process_count()}: OK ({n_local} local reads, "
        f"{n} kmers, {n_t} transcripts)",
        flush=True,
    )


def _check_sharded_spectrum(fasta, lo, hi, pad, capacity, pid) -> int:
    """Sharded count over the global mesh == SMOKE_EXPECTED's spectrum;
    returns its size."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from shannon_tpu.native import pack_file_range
    from shannon_tpu.parallel.distributed import count_spectrum_sharded
    from shannon_tpu.parallel.mesh import READS_AXIS, make_mesh

    batch = pack_file_range(fasta, lo, hi, pad_length=pad)
    n_local = batch.n_reads
    # equalize per-host rows for uniform shards (pad rows have no windows)
    counts = multihost_utils.process_allgather(np.array([n_local]))
    n_max = int(counts.max())
    codes = np.pad(
        batch.codes, ((0, n_max - n_local), (0, 0)), constant_values=4
    )
    lengths = np.pad(batch.lengths, (0, n_max - n_local)).astype(np.int32)

    mesh = make_mesh()
    gcodes = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(READS_AXIS, None)), codes
    )
    glengths = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(READS_AXIS)), lengths
    )
    spec, ovf = count_spectrum_sharded(
        gcodes, glengths, K, capacity=capacity, mesh=mesh
    )
    assert not bool(ovf), "sharded count overflowed"

    n = int(spec.n)
    hi_a = np.asarray(spec.hi)[:n].astype(np.uint64)
    lo_a = np.asarray(spec.lo)[:n].astype(np.uint64)
    keys = (hi_a << np.uint64(32)) | lo_a
    cnts = np.asarray(spec.count)[:n]
    exp = np.load(os.environ["SMOKE_EXPECTED"])
    assert np.array_equal(keys, exp["kmers"]), (
        f"proc {pid}: merged spectrum keys != single-process oracle "
        f"({n} vs {len(exp['kmers'])})"
    )
    assert np.array_equal(cnts, exp["counts"]), f"proc {pid}: counts differ"
    return n


def _launch_group(n_procs: int, work: Path, fasta: Path, expected_t: Path,
                  *, platform: str, pad: int, capacity: int, modes: str,
                  expected: Path | None = None,
                  timeout: float = 300) -> tuple[bool, list, list[str]]:
    """Launch one N-process child group; returns (ok, markers, outputs).
    On the GPU each child sees one card and must report NCCL."""
    for stale in work.glob("ok*.json"):
        stale.unlink()
    with socket.socket() as s:  # free localhost port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env_base = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "CUDA_VISIBLE_DEVICES")
    }
    env_base.update({
        "SMOKE_ROLE": "child",
        "SMOKE_FASTA": str(fasta),
        "SMOKE_EXPECTED": str(expected or ""),
        "SMOKE_EXPECTED_T": str(expected_t),
        "SMOKE_OUT": str(work),
        "SMOKE_PAD": str(pad),
        "SMOKE_CAPACITY": str(capacity),
        "SMOKE_MODES": modes,
        "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
        "JAX_NUM_PROCESSES": str(n_procs),
        "PYTHONPATH": str(REPO),
    })
    if platform == "cpu":
        env_base["JAX_PLATFORMS"] = "cpu"
        env_base["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    else:
        env_base["NCCL_DEBUG"] = "VERSION"  # NCCL prints its version

    def child_env(i: int) -> dict:
        env = {**env_base, "JAX_PROCESS_ID": str(i)}
        if platform != "cpu":
            env["CUDA_VISIBLE_DEVICES"] = str(i)
        return env

    procs = [
        subprocess.Popen(
            [sys.executable, __file__],
            env=child_env(i),
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(n_procs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    ok = all(p.returncode == 0 for p in procs)
    if platform != "cpu":
        ok = ok and all("NCCL version" in out for out in outs)
    markers = []
    for i in range(n_procs):
        mp = work / f"ok{i}.json"
        if mp.exists():
            markers.append(json.loads(mp.read_text()))
    return ok and len(markers) == n_procs, markers, outs


def _fasta_parity(work: Path, expected_t: set[str]) -> dict[str, bool]:
    """Per back-half mode: did process 0's transcripts.fasta hold the
    expected set?"""
    from shannon_tpu.io.dna import revcomp_str
    from shannon_tpu.io.fastx import read_fastx

    parity = {}
    for mode in ("ownership", "replicate"):
        fasta_out = work / f"pipeline_{mode}" / "transcripts.fasta"
        if fasta_out.exists():
            got = {
                min(seq, revcomp_str(seq)) for _h, seq in read_fastx(fasta_out)
            }
            parity[mode] = got == expected_t
    return parity


def _report_failure(outs_by_group: dict[int, list[str]]) -> None:
    for n_procs, outs in outs_by_group.items():
        for i, out in enumerate(outs):
            print(f"--- group {n_procs} child {i} output ---\n{out}",
                  file=sys.stderr)


def parent_cpu() -> None:
    import shutil
    import tempfile

    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.fastx import write_fasta
    from shannon_tpu.oracle import assemble_oracle
    from shannon_tpu.oracle.counting import count_kmers
    from shannon_tpu.sim import sample_reads, simulate_transcripts

    work = Path(tempfile.mkdtemp(prefix="multihost_smoke_"))
    rng = np.random.default_rng(5)
    ts = simulate_transcripts(rng, n=20, length=600)
    reads = sample_reads(rng, ts, coverage=8.0, read_length=60,
                         error_rate=0.01)
    fasta = work / "reads.fasta"
    write_fasta(fasta, [(f"r{i}", s) for i, s in enumerate(reads)])

    counts = count_kmers(reads, K, strand_specific=False)
    keys = np.fromiter(counts.keys(), np.uint64, len(counts))
    vals = np.fromiter(counts.values(), np.int64, len(counts)).astype(
        np.int32
    )
    order = np.argsort(keys)
    expected = work / "expected.npz"
    np.savez(expected, kmers=keys[order], counts=vals[order])

    # single-process oracle assembly of the WHOLE read set = the
    # transcript-parity target for the multi-process pipeline (device ==
    # oracle is pinned by the test suite)
    oracle_res = assemble_oracle(reads, AssemblyConfig(k=K))
    expected_t = sorted(oracle_res.canonical_set())
    expected_t_path = work / "expected_transcripts.json"
    expected_t_path.write_text(json.dumps(expected_t))

    t0 = time.perf_counter()
    groups = {}
    all_ok = True
    outs_by_group: dict[int, list[str]] = {}
    for n_procs, modes in ((2, "ownership,replicate"), (4, "ownership")):
        shutil.rmtree(work / "pipeline_ownership", ignore_errors=True)
        shutil.rmtree(work / "pipeline_replicate", ignore_errors=True)
        ok, markers, outs = _launch_group(
            n_procs, work, fasta, expected_t_path, platform="cpu", pad=PAD,
            capacity=1 << 15, modes=modes, expected=expected,
        )
        outs_by_group[n_procs] = outs
        fasta_parity = _fasta_parity(work, set(expected_t))
        volumes = None
        stats_p = work / "pipeline_ownership" / "stats.json"
        if stats_p.exists():
            asm = json.loads(stats_p.read_text()).get("stages", {}).get(
                "assembly", {}
            )
            volumes = {
                k: asm[k]
                for k in (
                    "ownership_sent_bytes",
                    "ownership_padded_bytes",
                    "replicate_equiv_bytes",
                    "owned_paths",
                    "local_paths",
                    "owned_components",
                )
                if k in asm
            }
        ok = ok and len(fasta_parity) == len(modes.split(",")) and all(
            fasta_parity.values()
        )
        all_ok = all_ok and ok
        groups[str(n_procs)] = {
            "ok": ok,
            "fasta_parity": fasta_parity,
            "comm_volumes_proc0": volumes,
            "processes": markers,
        }
    shutil.rmtree(work, ignore_errors=True)

    result = {
        "ok": all_ok,
        "wall_s": round(time.perf_counter() - t0, 1),
        "n_reads": len(reads),
        "n_kmers": int(len(keys)),
        "n_transcripts_expected": len(expected_t),
        "fasta_parity": all(
            g["fasta_parity"].get("ownership", False)
            and g["fasta_parity"].get("replicate", True)
            for g in groups.values()
        ),
        "backend": "cpu (localhost processes, jax.distributed)",
        "groups": groups,
        "processes": groups["2"]["processes"],
    }
    out_path = Path(os.environ.get("SMOKE_RESULT", "multihost_smoke.json"))
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    if not all_ok:
        _report_failure(outs_by_group)
        sys.exit(1)


def parent_given(platform: str, n_procs: int, fasta: Path, expected: Path,
                 work: Path) -> None:
    """One n_procs group on `platform` over `fasta`, ownership mode,
    expecting the transcript set of the FASTA at `expected`."""
    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.dna import revcomp_str
    from shannon_tpu.io.fastx import read_fastx
    from shannon_tpu.io.pack import auto_pad_length
    from shannon_tpu.native import load

    work.mkdir(parents=True, exist_ok=True)
    expected_t = sorted(
        {min(s, revcomp_str(s)) for _h, s in read_fastx(expected)}
    )
    expected_t_path = work / "expected_transcripts.json"
    expected_t_path.write_text(json.dumps(expected_t))
    pad = auto_pad_length(int(load().sti_max_seq_len(str(fasta).encode())))
    t0 = time.perf_counter()
    ok, markers, outs = _launch_group(
        n_procs, work, fasta, expected_t_path, platform=platform, pad=pad,
        capacity=AssemblyConfig.kmer_capacity, modes="ownership",
        timeout=1200,
    )
    parity = _fasta_parity(work, set(expected_t))
    ok = ok and parity.get("ownership", False)
    print(json.dumps({
        "ok": ok,
        "platform": platform,
        "wall_s": round(time.perf_counter() - t0, 1),
        "n_transcripts_expected": len(expected_t),
        "fasta_parity": parity,
        "processes": markers,
    }))
    if not ok:
        _report_failure({n_procs: outs})
        sys.exit(1)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--fasta", type=Path)
    ap.add_argument("--expected", type=Path,
                    help="transcripts.fasta of a single-process run")
    ap.add_argument("--work", type=Path)
    args = ap.parse_args()
    if args.fasta is None:
        if args.platform != "cpu":
            ap.error("--platform gpu needs --fasta, --expected and --work")
        parent_cpu()
    else:
        parent_given(args.platform, args.procs, args.fasta, args.expected,
                     args.work)


if __name__ == "__main__":
    if os.environ.get("SMOKE_ROLE") == "child":
        child()
    else:
        main()
