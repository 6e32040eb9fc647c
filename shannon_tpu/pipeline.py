"""Pipeline orchestrator — the reference's `shannon.py` stage sequencing
(SURVEY.md §4.1) rebuilt: ingest -> device k-mer spectrum (count +
correct) -> graph assembly (condense, thread, MB, SF) -> transcripts.

Contracts preserved from the reference (SURVEY.md §6):
  * stage outputs are serialized into the out-dir and double as
    checkpoints — re-running skips stages whose artifacts exist
    (config.resume);
  * per-stage wall-clock + counters go to timing.log / stats.json;
  * the oracle backend (`backend='oracle'`) runs the same stages in pure
    Python and must produce the identical transcript set (parity gate).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import encode_seq
from shannon_tpu.io.fastx import read_fastx, write_fasta
from shannon_tpu.io.pack import ReadBatch, pack_reads
from shannon_tpu.oracle.assemble import (
    AssemblyResult,
    Transcript,
    dedupe_and_filter,
    enumerate_transcripts,
)
from shannon_tpu.oracle.correction import clip_tips, correct_kmers
from shannon_tpu.oracle.counting import count_kmers
from shannon_tpu.oracle.graph import build_contigs
from shannon_tpu.oracle.multibridge import multibridge, thread_reads
from shannon_tpu.oracle.nodegraph import NodeGraph
from shannon_tpu.oracle.sparseflow import sparse_flow
from shannon_tpu.utils.timing import StageTimer


def _spectrum_device(
    batch: ReadBatch,
    config: AssemblyConfig,
    clip: bool = True,
    timer: StageTimer | None = None,
):
    """Device path: count + correct (+ tip-clip unless clip=False) on
    the device; returns (corrected Spectrum, post-clip ContigArrays or None)
    — the clip emits the condensed graph as a byproduct (condense once:
    ops.tipclip.clip_tips_graph), so callers only re-condense when it
    returns None (clip disabled / cycle fallback)."""
    import time as _time

    from shannon_tpu.ops.correction import correct_spectrum
    from shannon_tpu.ops.count import count_reads_spectrum
    from shannon_tpu.ops.tipclip import clip_tips_graph

    import jax

    t0 = _time.perf_counter()

    canonical = not config.strand_specific
    n_dev = config.n_devices or len(jax.devices())
    n_dev = min(n_dev, len(jax.devices()))
    if jax.process_count() > 1:
        # cross-host counting over the global mesh, then every host
        # continues on a local copy of the replicated spectrum (the
        # graph stages are deterministic, so the per-host recomputation
        # is redundant by design; evidence re-joins at gather_evidence)
        from shannon_tpu.parallel.mesh import make_mesh
        from shannon_tpu.parallel.multihost import (
            count_reads_spectrum_multihost,
            localize_spectrum,
        )

        spec, overflowed = count_reads_spectrum_multihost(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            mesh=make_mesh(),
            canonical=canonical,
            batch_reads=config.batch_reads,
        )
        spec = localize_spectrum(spec)
        overflowed = overflowed or spec.overflowed()
    elif n_dev > 1:
        from shannon_tpu.parallel.distributed import (
            count_reads_spectrum_sharded,
        )
        from shannon_tpu.parallel.mesh import make_mesh

        spec, overflowed = count_reads_spectrum_sharded(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            mesh=make_mesh(n_dev),
            canonical=canonical,
            batch_reads=config.batch_reads,
        )
        overflowed = overflowed or spec.overflowed()
    else:
        spec = count_reads_spectrum(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            canonical=canonical,
            batch_reads=config.batch_reads,
        )
        overflowed = spec.overflowed()
    if overflowed:
        raise RuntimeError(
            f"kmer_capacity={config.kmer_capacity} overflowed; raise "
            "AssemblyConfig.kmer_capacity"
        )
    spec.hi.block_until_ready()
    t1 = _time.perf_counter()
    if timer:
        timer.note("spectrum+graph", count_s=round(t1 - t0, 2))
    # shrink to tight capacity BEFORE correction: correction builds
    # [8, C] probe tables, so every lane of padding costs eight, and
    # every downstream stage gets smaller programs too
    # (ops/count.tight_capacity)
    from shannon_tpu.ops.count import shrink_spectrum

    pre = spec
    spec = shrink_spectrum(spec)
    if spec is not pre:
        # free the pre-shrink counting table NOW: correction's join
        # transients are the process peak, and the counting arenas are
        # pure dead weight from here on
        _release_device((pre.hi, pre.lo, pre.count))
    min_ab = config.min_abundance
    if min_ab == 0:
        # auto abundance threshold: one device histogram pass + the
        # recall-guarded chooser.  The small fetch resolves before correction dispatches; every host computes
        # the identical value from the replicated spectrum.
        from shannon_tpu.oracle.correction import choose_min_abundance
        from shannon_tpu.ops.correction import count_histogram

        min_ab = choose_min_abundance(np.asarray(count_histogram(spec, 1024)))
        if timer:
            timer.note("spectrum+graph", auto_min_abundance=min_ab)
    spec = correct_spectrum(
        spec,
        config.k,
        min_ab,
        config.sibling_ratio,
        config.correction_rounds,
        canonical=canonical,
        error_rate=config.error_rate,
    )
    # wait here so correction's time is not charged to the next stage
    spec.hi.block_until_ready()
    # re-shrink AFTER correction: with the abundance filter engaged the
    # corrected table can be several-fold smaller than the raw one
    # (most raw k-mers are error singletons at depth), and tip-clip
    # condensation cost is table-capacity-bound
    pre = spec
    spec = shrink_spectrum(spec)
    if spec is not pre:
        _release_device((pre.hi, pre.lo, pre.count))
    t2 = _time.perf_counter()
    if timer:
        timer.note("spectrum+graph", correct_s=round(t2 - t1, 2))
    if not clip:
        return spec, None
    tc_notes: dict = {}
    spec, ca = clip_tips_graph(
        spec, config, canonical=canonical, notes=tc_notes
    )
    spec.hi.block_until_ready()
    # tip clipping typically removes the majority of (error) k-mers:
    # re-shrink so any fallback re-condensation runs at the clipped
    # table's tight capacity, not the pre-clip one
    spec = shrink_spectrum(spec)
    if timer:
        timer.note(
            "spectrum+graph",
            tipclip_s=round(_time.perf_counter() - t2, 2),
            **tc_notes,
        )
    return spec, ca


def _graph_device(
    batch: ReadBatch,
    config: AssemblyConfig,
    timer: StageTimer | None = None,
):
    """Full on-device front half: spectrum + condensation; returns
    (ContigGraph materialized for the host assembler, #alive k-mers,
    device ContigArrays for further device stages).  The spectrum never
    round-trips through a Python dict (millions of boxed ints at
    scale)."""
    import time as _time

    from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph

    spec, ca = _spectrum_device(batch, config, timer=timer)
    t0 = _time.perf_counter()
    if ca is None:  # clip disabled or cycle fallback: condense here
        ca = build_contig_arrays(
            spec, config.k, canonical=not config.strand_specific
        )
    ca.out_edges.block_until_ready()
    t1 = _time.perf_counter()
    g = to_contig_graph(ca, config.k, config)
    if timer:
        timer.note(
            "spectrum+graph",
            condense_s=round(t1 - t0, 2),
            materialize_s=round(_time.perf_counter() - t1, 2),
        )
    return g, int(spec.n), ca


def _thread_device(
    batch: ReadBatch,
    ca,
    cgraph,
    config: AssemblyConfig,
    timer: StageTimer | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device read threading (hot loop #3) -> flat evidence arrays
    (flat node ids, row offsets, weights) for NodeGraph.set_paths_flat.

    Streams read batches (static shapes, compile-cache friendly) like
    the counting driver.  Each batch's outputs are compacted ACROSS
    reads on device (ops/thread.compact_thread_outputs) and downloaded
    at their counted size (~4 real events/read vs a 100-int32/read
    padded buffer).  The driver pipelines
    three stages a batch apart — kernel+compact dispatch, totals
    resolution -> pack dispatch at grid capacity, blocking download —
    so the device computes batch i+2 while batch i streams back.
    Single-end evidence is then built fully vectorized
    (runs_to_flat_paths); the paired path row-dedups (pairs as units)
    and runs the Python pair-joining over unique rows only."""
    import time as _time

    import jax.numpy as jnp

    from shannon_tpu.oracle.multibridge import expand_paths
    from shannon_tpu.oracle.nodegraph import _lists_to_flat
    from shannon_tpu.ops.thread import (
        compact_thread_outputs,
        evidence_grid,
        pack_evidence,
        paths_to_lists,
        runs_to_flat_paths,
        slice_nodes_for_threading,
        thread_reads_device_packed,
        unpack_evidence,
    )

    t0 = _time.perf_counter()
    ca = slice_nodes_for_threading(ca)  # join cost scales with table lanes
    n = batch.n_reads
    bs = config.batch_reads
    parts: list[tuple[dict, int, int]] = []
    stage_a: list[tuple] = []
    stage_b: list[tuple] = []

    def _drain_a() -> None:
        comp, n_events, lengths_j, n_real, n_pad = stage_a.pop(0)
        c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_runs, totals = comp
        tot_e, tot_r = (int(x) for x in np.asarray(totals))
        cap_e = min(evidence_grid(tot_e), int(c_cid.shape[0]))
        cap_r = min(
            evidence_grid(tot_r, minimum=1 << 11), int(c_p0.shape[0])
        )
        buf = pack_evidence(
            c_cid, c_run, c_p0, c_p1, c_o0, c_o1,
            n_events, n_runs, lengths_j, cap_e, cap_r,
        )
        stage_b.append((buf, cap_e, cap_r, n_real, n_pad))

    def _drain_b() -> None:
        buf, cap_e, cap_r, n_real, n_pad = stage_b.pop(0)
        d = unpack_evidence(np.asarray(buf), cap_e, cap_r, n_pad)
        d = {k: v[:n_real] for k, v in d.items()}
        parts.append((d, d["ev_cid"].shape[1], d["run_p0"].shape[1]))

    from shannon_tpu.ops.count import pad_batch_rows_words

    for s in range(0, n, bs):
        e = min(s + bs, n)
        # packed-resident rows slice straight into the upload (the 2-bit
        # words are the storage AND transfer format since round 5); the
        # mask upload only exists for slices with mid-read N's
        words, lengths, mask = pad_batch_rows_words(
            batch.words[s:e], batch.lengths[s:e], batch.mask_rows(s, e), bs
        )
        lengths_j = jnp.asarray(lengths)
        outs = thread_reads_device_packed(
            jnp.asarray(words),
            lengths_j,
            ca,
            config.k,
            length=batch.pad_length,
            mask=None if mask is None else jnp.asarray(mask),
        )
        comp = compact_thread_outputs(*outs)
        comp[-1].copy_to_host_async()  # totals resolve one batch late
        stage_a.append((comp, outs[2], lengths_j, e - s, words.shape[0]))
        if len(stage_a) >= 2:
            _drain_a()
        if len(stage_b) >= 2:
            _drain_b()
    while stage_a:
        _drain_a()
    while stage_b:
        _drain_b()
    empty = (np.empty(0, np.int64), np.zeros(1, np.int64), np.empty(0, np.int64))
    if not parts:
        return empty
    t1 = _time.perf_counter()

    if not (batch.paired and config.use_pairs):
        # ---- single-end: fully vectorized per part, then concatenate
        rc = (
            None
            if config.strand_specific
            else np.asarray(cgraph.rc_pair, np.int64)
        )
        flats, weights_l = [], []
        offs_l: list[np.ndarray] = []
        base = 0
        for d, _w, _r in parts:
            fl, of, wt = runs_to_flat_paths(
                d["ev_cid"], d["ev_run"], d["n_events"],
                d["run_p0"], d["run_p1"], rc, rescue=config.rescue_reads,
            )
            flats.append(fl)
            offs_l.append(of[1:] + base)
            weights_l.append(wt)
            base += of[-1]
        flat = np.concatenate(flats)
        offs = np.concatenate([np.zeros(1, np.int64), *offs_l])
        weights = np.concatenate(weights_l)
        if timer:
            timer.note(
                "threading",
                kernel_s=round(t1 - t0, 2),
                build_s=round(_time.perf_counter() - t1, 2),
                n_evidence_paths=len(weights),
            )
        return flat, offs, weights

    # ---- paired: row-dedup (pairs as units), then Python pair joining
    W = max(w for _p, w, _r in parts)
    R = max(r for _p, _w, r in parts)

    def _as_rows(d: dict, w: int, r: int) -> np.ndarray:
        def wide(a: np.ndarray, width: int, target: int) -> np.ndarray:
            if target > width:
                return np.pad(
                    a, ((0, 0), (0, target - width)), constant_values=-1
                )
            return a

        return np.hstack(
            [
                wide(d["ev_cid"], w, W),
                wide(d["ev_run"], w, W),
                d["n_events"][:, None],
                wide(d["run_p0"], r, R),
                wide(d["run_p1"], r, R),
                wide(d["run_o0"], r, R),
                wide(d["run_o1"], r, R),
                d["lengths"][:, None],
            ]
        )

    rows_all = np.vstack([_as_rows(d, w, r) for d, w, r in parts])
    ncol = rows_all.shape[1]
    group = 2 if rows_all.shape[0] % 2 == 0 else 1
    grouped = rows_all.reshape(-1, group * ncol)
    uniq, first, counts = np.unique(
        grouped, axis=0, return_index=True, return_counts=True
    )
    order = np.argsort(first, kind="stable")  # keep first-occurrence order
    uniq, counts = uniq[order], counts[order]
    urows = uniq.reshape(-1, ncol)
    c = 2 * W + 1
    raw = paths_to_lists(
        urows[:, :W],                  # ev_cid
        urows[:, W : 2 * W],           # ev_run
        urows[:, 2 * W],               # n_events
        urows[:, c : c + R],           # run_p0
        urows[:, c + R : c + 2 * R],   # run_p1
        urows[:, c + 2 * R : c + 3 * R],  # run_o0
        urows[:, c + 3 * R : c + 4 * R],  # run_o1
        rescue=config.rescue_reads,
    )
    pw = np.repeat(counts, group).astype(int).tolist()
    read_lengths = urows[:, c + 4 * R].astype(int).tolist()
    t2 = _time.perf_counter()
    paths, path_weights = expand_paths(
        raw, cgraph, config, paired=batch.paired, weights=pw,
        read_lengths=read_lengths,
    )
    flat, offs = _lists_to_flat(paths)
    if timer:
        timer.note(
            "threading",
            kernel_s=round(t1 - t0, 2),
            dedup_s=round(t2 - t1, 2),
            expand_s=round(_time.perf_counter() - t2, 2),
            unique_rows=len(urows),
        )
    return flat, offs, np.asarray(path_weights, np.int64)


def _spectrum_oracle(reads: list[str], config: AssemblyConfig) -> dict[int, int]:
    counts = count_kmers(reads, config.k, config.strand_specific)
    return correct_kmers(counts, config)


def _sf_solver(backend: str):
    """Sparse-flow solver for the backend: batched device kernel for
    'device', per-node host solver otherwise (identical results)."""
    if backend != "device":
        return None
    from shannon_tpu.ops.sparseflow import solve_nodes_device

    return solve_nodes_device


def _release_device(tree) -> None:
    """Explicitly free the device buffers backing a pytree.

    Called the moment a stage's arrays are dead (the contig/node tables
    after threading — the last device consumer).  Python's GC frees
    them eventually, but 'eventually' interleaves with the NEXT
    assembly's allocations, and at 4M-read table sizes a second
    in-process assembly can fail for a fragmented allocator
    (docs/SCALING.md known limit).  Early explicit deletion returns the
    largest blocks to the arena before any new allocation happens."""
    import jax

    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "delete"):
            try:
                leaf.delete()
            except Exception:
                pass  # already deleted / committed elsewhere


def _assemble_device_backhalf(
    cgraph, comps, evidence, config: AssemblyConfig, timer: StageTimer
):
    """Shared device-backend back half: evidence distribution (multi-
    process), NodeGraph build, bucket-scheduled MB+SF+enumeration,
    cross-host union, dedupe.  Returns (final transcripts, n_mb, n_sf,
    truncated).

    Multi-process modes (config.multihost_backhalf):
      * 'ownership' (default): each host assembles ONLY the components
        it owns (owner = component min-contig-id label mod H); evidence
        routes to owners with one all_to_all and raw transcripts are
        union-gathered before the final dedupe.  Communication scales
        with 1/H of the evidence instead of replicating all of it
        (docs/SCALING.md item 3 — the 100M-read design, now built).
        The union dedupe is order-independent (dedupe_and_filter keeps
        the max-abundance representative per canonical key and sorts
        keys), so the output is identical to single-process.
      * 'replicate': the round-4 behavior — all-gather ALL evidence,
        every host assembles everything redundantly (kept as the
        simple/fallback mode and as the comm-volume comparison
        baseline)."""
    import time as _time

    import jax as _jax

    H = _jax.process_count()
    ownership = H > 1 and config.multihost_backhalf == "ownership"
    if ownership:
        from shannon_tpu.parallel.multihost import (
            allreduce_stats,
            gather_transcripts,
            route_evidence_ownership,
        )

        owner = np.zeros(cgraph.n, np.int64)
        for comp in comps:
            owner[comp] = comp[0] % H
        vol: dict = {}
        evidence = route_evidence_ownership(*evidence, owner, volumes=vol)
        pid = _jax.process_index()
        my_comps = [c for c in comps if c[0] % H == pid]
        timer.note("assembly", owned_components=len(my_comps), **vol)
    elif H > 1:
        from shannon_tpu.parallel.multihost import gather_evidence

        evidence = gather_evidence(*evidence)
        timer.note("assembly", gathered_paths=len(evidence[2]))
        my_comps = comps
    else:
        my_comps = comps

    t0 = _time.perf_counter()
    g = NodeGraph.from_contig_graph(cgraph)
    t1 = _time.perf_counter()
    g.set_paths_flat(*evidence)
    timer.note(
        "assembly",
        graph_build_s=round(t1 - t0, 3),
        evidence_s=round(_time.perf_counter() - t1, 3),
    )
    from shannon_tpu.parallel.components import assemble_components

    transcripts, n_mb, n_sf, truncated, phase_s = assemble_components(
        g, my_comps, config, solver=_sf_solver("device")
    )
    for name, secs in phase_s.items():
        timer.note(name, wall_s=round(secs, 3))
    if ownership:
        transcripts = gather_transcripts(transcripts)
        n_mb, n_sf, trunc_i = allreduce_stats(n_mb, n_sf, int(truncated))
        truncated = bool(trunc_i)
    with timer.stage("dedupe"):
        final = dedupe_and_filter(transcripts, config)
    return final, n_mb, n_sf, truncated


def normalize_mate2(reads: list[str]) -> list[str]:
    """Flip interleaved mate-2 reads ([L0, R0, L1, R1, ...]) into
    transcript orientation (FR protocol: mate 2 is sequenced from the
    opposite strand).  Applied at ingest so counting (strand-specific
    mode) and threading see both mates on the same strand.  Runs through
    the same vectorized code-space RC as the file-ingest path
    (io.dna.revcomp_code_rows) so the two ingest routes cannot diverge."""
    from shannon_tpu.io.dna import decode_seq, encode_seq, revcomp_code_rows

    mates = reads[1::2]
    if not mates:
        return list(reads)
    pad = max(len(s) for s in mates)
    codes = np.full((len(mates), max(pad, 1)), 4, dtype=np.uint8)
    lengths = np.zeros(len(mates), dtype=np.int32)
    for i, s in enumerate(mates):
        enc = encode_seq(s)
        codes[i, : len(enc)] = enc
        lengths[i] = len(enc)
    rc = revcomp_code_rows(codes, lengths)
    out = list(reads)
    for i, li in enumerate(lengths):
        out[2 * i + 1] = decode_seq(rc[i, :li])
    return out


def ingest_paired_files(
    left: str, right: str, pad_length: int = 0
) -> ReadBatch:
    """Pack a paired library from two mate files into one interleaved
    batch [L0, R0, L1, R1, ...] with mate 2 flipped to transcript
    orientation.  Must stay batch-identical to the in-memory route
    pack_reads(normalize_mate2(interleaved), paired=True) — pinned by
    tests/test_pipeline.py::test_paired_ingest_file_vs_memory_batches."""
    from shannon_tpu.native import pack_file

    bl = pack_file(left, pad_length=pad_length)
    br = pack_file(right, pad_length=pad_length)
    if bl.n_reads != br.n_reads:
        raise ValueError(
            f"paired inputs differ in length: {bl.n_reads} vs {br.n_reads}"
        )
    return _interleave_pair_batches(bl, br)


def ingest_paired_files_range(
    left: str, right: str, pad_length: int
) -> ReadBatch:
    """Pair-aligned multi-host paired ingest (SURVEY.md §8 M5):
    byte-range-split the LEFT file over hosts, convert this
    host's byte range to a record range (native line scan), then read
    BOTH mate files at that record range
    (native.pack_file_records), so each host parses ~1/H of the pair
    data and every mate pair lands whole on exactly one host —
    replacing the parse-everything-then-slice fallback that repeated
    full parsing on every host at the 100M-paired north star.

    The two files cannot be byte-split independently (ranges could
    misalign mates); record indices are the pair-safe coordinate.
    Raises on gzip: the caller slices records instead."""
    from shannon_tpu.native import count_records_in_range, pack_file_records
    from shannon_tpu.parallel.multihost import host_byte_range

    if str(left).endswith(".gz") or str(right).endswith(".gz"):
        raise ValueError("pair-aligned range ingest requires uncompressed files")
    lo, hi = host_byte_range(left)
    skip = count_records_in_range(left, 0, lo)
    n_h = count_records_in_range(left, lo, hi)
    bl = pack_file_records(left, skip, n_h, pad_length)
    br = pack_file_records(right, skip, n_h, pad_length)
    return _interleave_pair_batches(bl, br)


def _interleave_pair_batches(bl: ReadBatch, br: ReadBatch) -> ReadBatch:
    """[L0, R0, L1, R1, ...] with mate 2 reverse-complemented into
    transcript orientation (FR protocol)."""
    from shannon_tpu.io.dna import revcomp_code_rows
    # auto pad may differ between the two files (e.g. 150bp vs 151bp
    # libraries): widen both to the common pad.  The interleave + mate-2
    # RC runs on transient uint8 views (batches are packed-resident);
    # the result re-packs in the ReadBatch constructor.
    pad = max(bl.pad_length, br.pad_length)
    n = bl.n_reads
    codes = np.full((2 * n, pad), 4, np.uint8)
    lengths = np.empty(2 * n, np.int32)
    codes[0::2, : bl.pad_length] = bl.codes
    lengths[0::2] = bl.lengths
    codes[1::2, : br.pad_length] = revcomp_code_rows(br.codes, br.lengths)
    lengths[1::2] = br.lengths
    return ReadBatch(codes=codes, lengths=lengths, paired=True)


def assemble(
    reads: list[str],
    config: AssemblyConfig | None = None,
    backend: str = "device",
    timer: StageTimer | None = None,
    paired: bool = False,
) -> AssemblyResult:
    """In-memory end-to-end assembly.  backend: 'device' (device spectrum) or
    'oracle' (pure Python spectrum); both share the graph/assembly stages
    and must produce identical output (tested).  paired: reads are
    interleaved [L0, R0, ...] with mate 2 as sequenced (it is
    orientation-normalized here)."""
    config = config or AssemblyConfig()
    timer = timer or StageTimer(echo=False)
    if paired:
        reads = normalize_mate2(reads)

    if backend == "device":
        from shannon_tpu.parallel.components import device_components

        with timer.stage("spectrum+graph", n_reads=len(reads)):
            batch = pack_reads(
                reads, pad_length=config.read_pad_length, paired=paired
            )
            cgraph, n_alive, ca = _graph_device(batch, config, timer=timer)
        with timer.stage("partition"):
            comps = device_components(ca)  # GPMETIS replacement, on device
        with timer.stage("threading"):
            evidence = _thread_device(batch, ca, cgraph, config, timer=timer)
        _release_device(ca)  # last device consumer of the node tables
    elif backend == "oracle":
        with timer.stage("spectrum", n_reads=len(reads)):
            alive = _spectrum_oracle(reads, config)
            alive = clip_tips(alive, config)
            n_alive = len(alive)
        with timer.stage("graph"):
            cgraph = build_contigs(alive, config)
            comps = cgraph.components()
        with timer.stage("threading"):
            read_codes = [encode_seq(s) for s in reads]
            paths, path_weights = thread_reads(
                read_codes, cgraph, config, paired=paired
            )
    else:
        raise ValueError(f"unknown backend {backend!r}")

    with timer.stage("assembly"):
        if backend == "device":
            # bucket-scheduled per-component back-half (the GNU-parallel
            # replacement; identical output to the whole-graph oracle path)
            final, n_mb, n_sf, truncated = _assemble_device_backhalf(
                cgraph, comps, evidence, config, timer
            )
        else:
            g = NodeGraph.from_contig_graph(cgraph, paths, path_weights)
            with timer.stage("multibridge"):
                n_mb = multibridge(g, config)
            with timer.stage("sparseflow"):
                n_sf = sparse_flow(g, config, solver=_sf_solver(backend))
            with timer.stage("enumerate"):
                transcripts, truncated = enumerate_transcripts(g, config)
            with timer.stage("dedupe"):
                final = dedupe_and_filter(transcripts, config)

    stats = {
        "n_reads": len(reads),
        "n_kmers_final": n_alive,
        "n_contigs": cgraph.n,
        "n_components": len(comps),
        "n_mb_splits": n_mb,
        "n_sf_splits": n_sf,
        "n_transcripts": len(final),
        "truncated": truncated,
        "backend": backend,
    }
    timer.note("assembly", **{k: v for k, v in stats.items() if k != "backend"})
    return AssemblyResult(transcripts=final, stats=stats)


# ---------------------------------------------------------------------
# File-based pipeline with stage checkpoints (reference CLI contract)
# ---------------------------------------------------------------------


def run_pipeline(
    config: AssemblyConfig,
    single: str | None = None,
    left: str | None = None,
    right: str | None = None,
    backend: str = "device",
) -> AssemblyResult:
    """File in -> out-dir artifacts -> transcripts.fasta.

    Stage artifacts (skipped on re-run when present and config.resume):
      reads.npz       ingested, encoded, padded reads
      spectrum.npz    corrected k-mer spectrum
      transcripts.fasta  final output
    """
    import jax as _jax0

    pid = _jax0.process_index()
    multi_proc = _jax0.process_count() > 1
    out = Path(config.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if pid == 0:
        (out / "config.json").write_text(config.to_json())
    # multi-process: per-host reads checkpoint (each host holds its own
    # slice); spectrum/transcript artifacts are identical on every host
    # and written by process 0 only (single-writer-per-file, SURVEY §6)
    timer = StageTimer(out_dir=out if pid == 0 else None)

    reads_npz = out / (f"reads.p{pid}.npz" if multi_proc else "reads.npz")
    if config.resume and reads_npz.exists():
        data = np.load(reads_npz)
        if "words" in data:
            batch = ReadBatch(
                words=data["words"],
                lengths=data["lengths"],
                paired=bool(data["paired"]),
                pad_length=int(data["pad_length"]),
                mask=data["mask"] if "mask" in data.files else None,
            )
        else:  # older uint8-code checkpoint
            batch = ReadBatch(
                codes=data["codes"],
                lengths=data["lengths"],
                paired=bool(data["paired"]),
            )
        timer.note("ingest", skipped=True, n_reads=batch.n_reads)
    else:
        with timer.stage("ingest"):
            import jax as _jax

            from shannon_tpu.native import pack_file

            multi = _jax.process_count() > 1
            if single is not None:
                if multi and not str(single).endswith(".gz"):
                    # per-host byte-range ingest: each host parses ~1/N
                    # of the file's bytes (SURVEY.md §8 M5)
                    from shannon_tpu.native import pack_file_range
                    from shannon_tpu.parallel.multihost import (
                        host_byte_range,
                    )

                    if config.read_pad_length == 0:
                        raise ValueError(
                            "multi-host byte-range ingest needs an "
                            "explicit read_pad_length (auto sizing "
                            "would let hosts disagree on shapes)"
                        )
                    lo, hi = host_byte_range(single)
                    batch = pack_file_range(
                        single, lo, hi, pad_length=config.read_pad_length
                    )
                    multi = False  # already sliced
                else:
                    batch = pack_file(
                        single, pad_length=config.read_pad_length
                    )
            elif left is not None and right is not None:
                gz = str(left).endswith(".gz") or str(right).endswith(".gz")
                if multi and config.read_pad_length and not gz:
                    # pair-aligned per-host range ingest
                    batch = ingest_paired_files_range(
                        left, right, config.read_pad_length
                    )
                    multi = False  # already sliced, pair-aligned
                else:
                    batch = ingest_paired_files(
                        left, right, pad_length=config.read_pad_length
                    )
            else:
                raise ValueError("provide --single or --left/--right")

            if multi:
                # paired / gzip multi-host fallback: each host keeps its
                # contiguous, pair-aligned record slice (byte-range
                # splitting two pair files independently could misalign
                # mates; gzip offsets are not record-addressable)
                from shannon_tpu.parallel.multihost import host_read_slice

                sl = host_read_slice(batch.n_reads)
                batch = batch.rows(sl)
            np.savez_compressed(
                reads_npz,
                words=batch.words,
                lengths=batch.lengths,
                paired=batch.paired,
                pad_length=batch.pad_length,
                **({"mask": batch.mask} if batch.mask is not None else {}),
            )
        timer.note("ingest", n_reads=batch.n_reads, total_bases=batch.total_bases)

    spectrum_npz = out / "spectrum.npz"
    ca_live = None  # post-clip ContigArrays when the clip ran in-process
    if config.resume and spectrum_npz.exists():
        data = np.load(spectrum_npz)
        keys = data["kmers"]
        vals = data["counts"]
        alive = None
        timer.note("spectrum", skipped=True, n_kmers=len(keys))
    else:
        with timer.stage("spectrum", n_reads=batch.n_reads):
            if backend == "device":
                from shannon_tpu.ops.count import spectrum_from_arrays
                from shannon_tpu.ops.kmers import hilo_to_int
                from shannon_tpu.ops.tipclip import clip_tips_graph

                # intermediate checkpoint between counting+correction and
                # tip clipping: the expensive count phase is not redone if
                # a later stage fails or is being iterated on
                corrected_npz = out / "spectrum_corrected.npz"
                if config.resume and corrected_npz.exists():
                    d = np.load(corrected_npz)
                    spec_dev = spectrum_from_arrays(d["kmers"], d["counts"])
                else:
                    spec_dev, _ = _spectrum_device(batch, config, clip=False)
                    nk0 = int(spec_dev.n)
                    if pid == 0:
                        np.savez_compressed(
                            corrected_npz,
                            kmers=hilo_to_int(
                                spec_dev.hi[:nk0], spec_dev.lo[:nk0]
                            ),
                            counts=np.asarray(spec_dev.count[:nk0], np.int64),
                        )
                spec_dev, ca_live = clip_tips_graph(
                    spec_dev, config, canonical=not config.strand_specific
                )
                nk = int(spec_dev.n)
                keys = hilo_to_int(spec_dev.hi[:nk], spec_dev.lo[:nk])
                vals = np.asarray(spec_dev.count[:nk], dtype=np.int64)
            else:
                alive = _spectrum_oracle(batch.sequences(), config)
                alive = clip_tips(alive, config)
                keys = np.fromiter(alive.keys(), dtype=np.uint64, count=len(alive))
                vals = np.fromiter(alive.values(), dtype=np.int64, count=len(alive))
                order = np.argsort(keys)
                keys, vals = keys[order], vals[order]
        if pid == 0:
            np.savez_compressed(spectrum_npz, kmers=keys, counts=vals)
        timer.note("spectrum", n_kmers=len(keys))

    fasta = out / "transcripts.fasta"
    if config.resume and fasta.exists():
        transcripts = [
            Transcript(seq=seq, abundance=float(h.split("abundance=")[1]))
            for h, seq in read_fastx(fasta)
        ]
        result = AssemblyResult(transcripts=transcripts, stats={"resumed": True})
        timer.note("assembly", skipped=True, n_transcripts=len(transcripts))
    else:
        if backend == "device":
            from shannon_tpu.ops.condense import (
                build_contig_arrays,
                to_contig_graph,
            )
            from shannon_tpu.ops.count import spectrum_from_arrays

            with timer.stage("graph"):
                if ca_live is not None:  # clip already condensed it
                    ca = ca_live
                else:
                    spec = spectrum_from_arrays(keys, vals)
                    ca = build_contig_arrays(
                        spec, config.k, canonical=not config.strand_specific
                    )
                cgraph = to_contig_graph(ca, config.k, config)
            with timer.stage("partition"):
                from shannon_tpu.parallel.components import device_components

                comps = device_components(ca)
            with timer.stage("threading"):
                evidence = _thread_device(batch, ca, cgraph, config, timer=timer)
            _release_device(ca)
        else:
            with timer.stage("graph"):
                if alive is None:
                    alive = {
                        int(k): int(c) for k, c in zip(keys, vals)
                    }
                cgraph = build_contigs(alive, config)
                comps = cgraph.components()
            with timer.stage("threading"):
                read_codes = [encode_seq(s) for s in batch.sequences()]
                paths, path_weights = thread_reads(
                    read_codes, cgraph, config, paired=batch.paired
                )
        with timer.stage("assembly"):
            if backend == "device":
                final, n_mb, n_sf, truncated = _assemble_device_backhalf(
                    cgraph, comps, evidence, config, timer
                )
            else:
                g = NodeGraph.from_contig_graph(cgraph, paths, path_weights)
                n_mb = multibridge(g, config)
                n_sf = sparse_flow(g, config, solver=_sf_solver(backend))
                transcripts_all, truncated = enumerate_transcripts(g, config)
                final = dedupe_and_filter(transcripts_all, config)
        if pid == 0:  # single writer; every host computed the same set
            write_fasta(
                fasta,
                [
                    (f"shannon_tpu_{i} abundance={t.abundance:.4f}", t.seq)
                    for i, t in enumerate(final)
                ],
            )
        result = AssemblyResult(
            transcripts=final,
            stats={
                "n_reads": batch.n_reads,
                "n_kmers_final": len(keys),
                "n_contigs": cgraph.n,
                "n_components": len(comps),
                "n_mb_splits": n_mb,
                "n_sf_splits": n_sf,
                "n_transcripts": len(final),
                "truncated": truncated,
                "backend": backend,
            },
        )
        timer.note("assembly", n_transcripts=len(final))
    timer.flush_stats(extra={"result": result.stats})
    return result
