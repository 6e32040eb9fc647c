"""CLI — mirrors the reference's `shannon.py` argument surface
(SURVEY.md §3.1: `python shannon.py -o OUT [--single r.fa | --left l.fq
--right r.fq] [-p N] [-K 24]`) so parity runs are drop-in.

    shannon-tpu -o OUT --single reads.fasta -K 24
    shannon-tpu -o OUT --left l.fastq --right r.fastq
    python -m shannon_tpu.cli ...
"""

from __future__ import annotations

import argparse
import sys

from shannon_tpu.config import AssemblyConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shannon-tpu",
        description="de novo RNA-seq transcriptome assembler in JAX",
    )
    p.add_argument("-o", "--out-dir", required=True, help="output directory")
    src = p.add_argument_group("input (single OR paired)")
    src.add_argument("--single", help="single-end reads (FASTA/FASTQ, .gz ok)")
    src.add_argument("--left", help="paired-end left/mate-1 reads")
    src.add_argument("--right", help="paired-end right/mate-2 reads")
    p.add_argument("-K", "-k", "--kmer-size", type=int, default=24, dest="k")
    p.add_argument(
        "-p", "--partitions", type=int, default=0,
        help="device count to shard across (0 = all visible; the "
        "reference's process-pool width analog)",
    )
    p.add_argument("--ss", "--strand-specific", action="store_true",
                   dest="strand_specific", help="strand-specific protocol")
    p.add_argument("--min-abundance", type=int, default=0,
                   help="drop k-mers below this count; 0 (default) = "
                        "auto from the count histogram (recall-guarded "
                        "coverage ladder; shallow/clean data stays "
                        "unfiltered)")
    p.add_argument("--sibling-ratio", type=float, default=0.1,
                   help="error-branch pruning ratio (0 disables)")
    p.add_argument(
        "--error-branch-ratio", type=float,
        default=AssemblyConfig.error_branch_ratio,
        help="stricter pruning ratio for branches at the single-error "
             "footprint length <= k+2 (0 disables)",
    )
    p.add_argument("--min-transcript-length", type=int, default=200)
    p.add_argument(
        "--no-pairs", action="store_true",
        help="ignore paired-end mate/insert-size evidence in "
             "multibridging (pairs are used by default)",
    )
    p.add_argument(
        "--insert-size", type=int, default=AssemblyConfig.insert_size,
        help="mean fragment (insert) length of the paired library; "
             "0 = estimate from the data",
    )
    p.add_argument(
        "--insert-size-std", type=float,
        default=AssemblyConfig.insert_size_std,
        help="fragment length standard deviation; 0 = estimate "
             "(1.4826*MAD, or 10%% of --insert-size when given)",
    )
    p.add_argument("--kmer-capacity", type=int, default=1 << 22,
                   help="device spectrum table capacity")
    p.add_argument("--read-pad-length", type=int, default=0,
                   help="device read padding; 0 = auto-size to the "
                        "longest read (32-base grid, never truncates)")
    p.add_argument("--no-resume", action="store_true",
                   help="recompute every stage even if artifacts exist")
    p.add_argument("--backend", choices=["device", "oracle"], default="device",
                   help="'oracle' = pure-Python reference-semantics path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--min-output-abundance", type=float,
        default=AssemblyConfig.min_output_abundance,
    )
    p.add_argument("--profile", action="store_true",
                   help="write a jax.profiler trace to OUT/profile "
                   "(open with TensorBoard / xprof)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if bool(args.single) == bool(args.left or args.right):
        print("error: provide exactly one of --single or --left/--right",
              file=sys.stderr)
        return 2
    if bool(args.left) != bool(args.right):
        print("error: --left and --right must be given together",
              file=sys.stderr)
        return 2
    config = AssemblyConfig(
        k=args.k,
        min_abundance=args.min_abundance,
        strand_specific=args.strand_specific,
        sibling_ratio=args.sibling_ratio,
        error_branch_ratio=args.error_branch_ratio,
        min_transcript_length=args.min_transcript_length,
        min_output_abundance=args.min_output_abundance,
        use_pairs=not args.no_pairs,
        insert_size=args.insert_size,
        insert_size_std=args.insert_size_std,
        kmer_capacity=args.kmer_capacity,
        read_pad_length=args.read_pad_length,
        out_dir=args.out_dir,
        n_devices=args.partitions,
        resume=not args.no_resume,
        seed=args.seed,
    )
    from shannon_tpu.pipeline import run_pipeline
    from shannon_tpu.utils.jaxcache import enable_compilation_cache

    if args.backend == "device":
        enable_compilation_cache()
        from shannon_tpu.parallel.multihost import init_distributed
        from shannon_tpu.utils.device import require_gpu

        init_distributed()  # before the first backend query
        require_gpu()

    profiler_cm = None
    if args.profile:
        import contextlib

        import jax

        profiler_cm = jax.profiler.trace(f"{args.out_dir}/profile")
        profiler_cm.__enter__()

    try:
        result = run_pipeline(
            config,
            single=args.single,
            left=args.left,
            right=args.right,
            backend=args.backend,
        )
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
    print(
        f"done: {len(result.transcripts)} transcripts -> "
        f"{config.out_dir}/transcripts.fasta"
    )
    for k, v in sorted(result.stats.items()):
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
