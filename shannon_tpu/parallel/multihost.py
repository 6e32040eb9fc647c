"""Multi-host initialization (SURVEY.md §8 M5, BASELINE config 5).

One call sets up `jax.distributed` when launched under a multi-host
coordinator (JAX_COORDINATOR_ADDRESS); it is a no-op in a
single-process session, so every entry point can call it
unconditionally.  Read sharding across hosts composes with the local
mesh: each host feeds its local shard of the interleaved read files
into the same `count_spectrum_sharded` all-to-all (the global mesh axis
spans all devices of all hosts; on GPUs NCCL carries the
collectives).
"""

from __future__ import annotations

import os


def init_distributed() -> bool:
    """Initialize jax.distributed if a coordinator is configured.
    Returns True when running multi-process.

    Order matters: `jax.distributed.initialize` must run BEFORE the
    first backend query (`jax.process_count()` initializes the backend),
    so the coordinator env is checked first.  Idempotent: a second call
    in an already-initialized process is a no-op.  Exercised by
    scripts/multihost_smoke.py (2-process CPU launch) and its pytest."""
    import jax

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr and not _distributed_initialized():
        if os.environ.get("JAX_PLATFORMS", "") == "cpu":
            # CPU multi-process collectives need gloo (GPUs use NCCL)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
    return jax.process_count() > 1


def _distributed_initialized() -> bool:
    import jax

    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None:
        return bool(is_init())
    from jax._src import distributed  # jax without the public probe

    return distributed.global_state.client is not None


def host_byte_range(path: str | os.PathLike) -> tuple[int, int]:
    """This host's byte range of an (uncompressed) input file: equal
    byte split of [0, file_size) over processes.  Combined with
    native.pack_file_range's record-ownership contract (a record
    belongs to the range holding its header byte), each host parses
    ~1/N of the file and every record lands on exactly one host —
    replacing the parse-everything-then-slice ingest (SURVEY.md §8 M5;
    at the 100M-read workload ceiling the old scheme repeated hours of
    parsing on every host)."""
    import jax

    size = os.path.getsize(path)
    p, n = jax.process_index(), jax.process_count()
    return p * size // n, (p + 1) * size // n


def allgather_ragged(a):
    """All-gather a per-process ragged array (axis 0 may differ per
    process) into the process-rank-order concatenation, replicated on
    every process: gather lengths, pad to the max, gather data, trim."""
    import numpy as np
    from jax.experimental import multihost_utils

    a = np.asarray(a)
    ns = multihost_utils.process_allgather(
        np.array([a.shape[0]], np.int64)
    ).ravel()
    m = int(ns.max())
    pad = np.zeros((m,) + a.shape[1:], a.dtype)
    pad[: a.shape[0]] = a
    g = multihost_utils.process_allgather(pad)
    return np.concatenate(
        [g[p, : int(ns[p])] for p in range(len(ns))], axis=0
    )


def gather_evidence(flat, offs, weights):
    """Gather per-host threading evidence (flat node ids, row offsets,
    weights — ops/thread.runs_to_flat_paths format) into the global
    evidence set, replicated on every process (a back half on local
    evidence only would write a different, incomplete transcripts.fasta
    on each host).

    Rank-order concatenation reproduces the single-process evidence
    order exactly: hosts own contiguous, ascending byte ranges of the
    input, so host-rank order IS global read order — first-occurrence
    path dedup (NodeGraph.set_paths_flat) and every downstream
    tie-break see the same sequence as a single-process run."""
    import jax

    if jax.process_count() == 1:
        return flat, offs, weights
    import numpy as np

    lens = np.diff(np.asarray(offs, np.int64))
    g_flat = allgather_ragged(np.asarray(flat, np.int64))
    g_lens = allgather_ragged(lens)
    g_w = allgather_ragged(np.asarray(weights, np.int64))
    offs2 = np.zeros(len(g_lens) + 1, np.int64)
    np.cumsum(g_lens, out=offs2[1:])
    return g_flat, offs2, g_w


def route_evidence_ownership(flat, offs, weights, owner_of_node, volumes=None):
    """Component-ownership evidence exchange (docs/SCALING.md item 3):
    instead of all-gathering ALL evidence
    to every host (communication and assembly both scale with the GLOBAL
    read count), each path is routed to the single host that OWNS its
    component — owner(component) = min-contig-id label mod H, identical
    on every host because the graph stages are deterministic and
    replicated.  A path never leaves its component (every step follows
    an edge), so its head node's component owns the whole path.

    Exchange is ONE device all_to_all over the global mesh (the same
    collective transport the sharded counter uses): per-destination
    buckets packed as int32 [n_paths, n_flat, lens, weights, flat],
    padded to the globally-agreed max bucket size.  Returns the
    (flat, offs, weights) of the paths THIS host owns, concatenated in
    (source rank, source-local order) — rank order is global read
    order (hosts ingest ascending byte ranges), so per-component
    evidence order, dedup first-occurrence, and every tie-break match
    the single-process run exactly.

    `volumes`, if given, receives measured communication volumes:
    ownership_sent_bytes (real payload to other hosts),
    ownership_padded_bytes (padded all_to_all upload) and
    replicate_equiv_bytes (what the all-gather path would have sent:
    (H-1) x the full local evidence)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from shannon_tpu.parallel.mesh import READS_AXIS, make_mesh

    H = jax.process_count()
    if H == 1:
        return flat, offs, weights
    pid = jax.process_index()
    flat = np.asarray(flat, np.int64)
    offs = np.asarray(offs, np.int64)
    weights = np.asarray(weights, np.int64)
    if flat.max(initial=0) >= 2**31 or weights.max(initial=0) >= 2**31:
        raise ValueError("evidence exceeds int32 transport range")
    lens = np.diff(offs)
    dest_p = np.asarray(owner_of_node, np.int64)[
        flat[offs[:-1]] if len(lens) else np.empty(0, np.int64)
    ]

    mesh = make_mesh()
    devs = mesh.devices.ravel()
    D = devs.size
    dpp = D // H  # devices per process; buckets ride each process's
    # first device (empty elsewhere) so the routing is process-level
    first_dev_of_proc = {p: None for p in range(H)}
    proc_of_dev = np.empty(D, np.int64)
    for di, d in enumerate(devs):
        proc_of_dev[di] = d.process_index
        if first_dev_of_proc[d.process_index] is None:
            first_dev_of_proc[d.process_index] = di
    if (np.diff(proc_of_dev) < 0).any():
        raise ValueError("mesh devices must be ordered by process")
    my_first = first_dev_of_proc[pid]

    buckets: list[np.ndarray] = []
    sent_real = 0
    for p in range(H):
        sel = dest_p == p
        bl = lens[sel]
        bw = weights[sel]
        bf = flat[np.repeat(sel, lens)] if len(lens) else flat[:0]
        buf = np.concatenate(
            [
                np.array([len(bl), len(bf)], np.int64),
                bl,
                bw,
                bf,
            ]
        ).astype(np.int32)
        buckets.append(buf)
        if p != pid:
            sent_real += buf.nbytes
    cap_local = max((len(b) for b in buckets), default=2)
    cap = int(
        multihost_utils.process_allgather(
            np.array([cap_local], np.int64)
        ).max()
    )

    # buckets ride this process's FIRST device row (other local devices
    # send empty buckets); destination bucket lands at the destination
    # process's first-device slot
    send_local = np.zeros((dpp, D * cap), np.int32)
    local_devs = [di for di in range(D) if proc_of_dev[di] == pid]
    row = local_devs.index(my_first)
    for p in range(H):
        fd = first_dev_of_proc[p]
        send_local[row, fd * cap : fd * cap + len(buckets[p])] = buckets[p]

    sh = NamedSharding(mesh, P(READS_AXIS, None))
    g = jax.make_array_from_process_local_data(sh, send_local)

    def _xch(x):  # [1, D*cap] per device
        b = x.reshape(D, cap)
        b = jax.lax.all_to_all(b, READS_AXIS, 0, 0, tiled=False)
        return b.reshape(1, D * cap)

    fn = jax.jit(
        shard_map(
            _xch, mesh=mesh, in_specs=P(READS_AXIS, None),
            out_specs=P(READS_AXIS, None), check_vma=False,
        )
    )
    recv = fn(g)
    # my first device's row holds the buckets destined to this process
    mine = None
    for s in recv.addressable_shards:
        if s.index[0].start == my_first:
            mine = np.asarray(s.data).reshape(D, cap)
            break
    assert mine is not None, "first-device shard not addressable"

    parts_l, parts_w, parts_f = [], [], []
    for src in range(D):
        if first_dev_of_proc[int(proc_of_dev[src])] != src:
            continue  # only first devices carry buckets
        b = mine[src]
        n_p, n_f = int(b[0]), int(b[1])
        c = 2
        parts_l.append(b[c : c + n_p].astype(np.int64)); c += n_p
        parts_w.append(b[c : c + n_p].astype(np.int64)); c += n_p
        parts_f.append(b[c : c + n_f].astype(np.int64))
    g_lens = np.concatenate(parts_l) if parts_l else np.empty(0, np.int64)
    g_w = np.concatenate(parts_w) if parts_w else np.empty(0, np.int64)
    g_flat = np.concatenate(parts_f) if parts_f else np.empty(0, np.int64)
    offs2 = np.zeros(len(g_lens) + 1, np.int64)
    np.cumsum(g_lens, out=offs2[1:])
    if volumes is not None:
        local_bytes = 4 * (len(flat) + 2 * len(lens))
        volumes.update(
            ownership_sent_bytes=int(sent_real),
            ownership_padded_bytes=int(send_local.nbytes),
            replicate_equiv_bytes=int((H - 1) * local_bytes),
            owned_paths=int(len(g_lens)),
            local_paths=int(len(lens)),
        )
    return g_flat, offs2, g_w


def gather_transcripts(transcripts):
    """Union of per-host raw transcript lists in rank order (the
    ownership back half assembles disjoint component subsets; the final
    dedupe + sort runs on the union, whose result is order-independent:
    dedupe keeps the canonical key with max abundance and sorts keys)."""
    import jax
    import numpy as np

    from shannon_tpu.oracle.assemble import Transcript

    if jax.process_count() == 1:
        return transcripts
    seq_cat = "".join(t.seq for t in transcripts)
    seqs = np.frombuffer(seq_cat.encode("ascii"), np.uint8)
    lens = np.fromiter(
        (len(t.seq) for t in transcripts), np.int64, len(transcripts)
    )
    abunds = np.fromiter(
        (t.abundance for t in transcripts), np.float64, len(transcripts)
    )
    g_seqs = allgather_ragged(seqs)
    g_lens = allgather_ragged(lens)
    g_ab = allgather_ragged(abunds)
    out = []
    pos = 0
    blob = g_seqs.tobytes().decode("ascii")
    for l, a in zip(g_lens, g_ab):
        out.append(Transcript(seq=blob[pos : pos + int(l)], abundance=float(a)))
        pos += int(l)
    return out


def allreduce_stats(*vals: int) -> list[int]:
    """Sum small per-host integer stats across processes."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return list(vals)
    g = multihost_utils.process_allgather(np.array(vals, np.int64))
    return [int(x) for x in g.sum(axis=0)]


def localize_spectrum(spec):
    """Replicated-global Spectrum (out of the multi-process sharded
    count) -> process-local arrays, so the downstream per-host stages
    (correction probes, tip clip, condensation, threading lookups) run
    as plain local jits without touching the global mesh.  Every
    process holds the identical value, so the local recomputation of
    the graph is deterministic and redundant by design."""
    import jax.numpy as jnp
    import numpy as np

    from shannon_tpu.ops.count import Spectrum

    return Spectrum(
        hi=jnp.asarray(np.asarray(spec.hi)),
        lo=jnp.asarray(np.asarray(spec.lo)),
        count=jnp.asarray(np.asarray(spec.count)),
        n=jnp.int32(int(spec.n)),
    )


def count_reads_spectrum_multihost(
    batch,
    k: int,
    capacity: int,
    mesh,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
):
    """Multi-PROCESS batched counting driver: each process feeds its
    local read slice (`batch`: a packed-resident ReadBatch); batches
    are padded to a uniform per-host row count, assembled into global
    arrays over the cross-host mesh
    (jax.make_array_from_process_local_data), and counted with the
    packed sharded program (one hash all_to_all).  Mirrors
    parallel.distributed.count_reads_spectrum_sharded, including the
    packed uploads and the one-batch-lagged async overflow resolution.
    Returns (replicated global Spectrum, overflowed).

    The invalid-base mask is ALWAYS built here (even for clean
    batches): program structure must agree across processes, and a
    per-batch has-N negotiation would cost an allgather per batch.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from shannon_tpu.io.pack import zero_mask_words
    from shannon_tpu.ops.count import (
        SENTINEL,
        Spectrum,
        _overflow_flag,
        merge_spectra_fixed,
        merge_spectra_sized,
    )
    from shannon_tpu.parallel.distributed import (
        count_spectrum_sharded_packed,
    )
    from shannon_tpu.parallel.mesh import READS_AXIS

    n_local = batch.n_reads
    L = batch.pad_length
    ns = multihost_utils.process_allgather(
        np.array([n_local], np.int64)
    ).ravel()
    n_batches = max(1, -(-int(ns.max()) // batch_reads))
    sh_rows = NamedSharding(mesh, P(READS_AXIS, None))
    sh_vec = NamedSharding(mesh, P(READS_AXIS))

    total: Spectrum | None = None
    overflowed = False
    pending: tuple | None = None

    def _resolve() -> None:
        nonlocal total, overflowed, pending
        if pending is None:
            return
        prev_total, part, ovf, mflag = pending
        pending = None
        overflowed |= bool(ovf)
        if mflag is not None and bool(mflag):
            total = merge_spectra_sized(prev_total, part)

    for b in range(n_batches):
        s = min(b * batch_reads, n_local)
        e = min(s + batch_reads, n_local)
        words = batch.words[s:e]
        lengths = np.asarray(batch.lengths[s:e], np.int32)
        mask = batch.mask_rows(s, e)
        pad = batch_reads - words.shape[0]
        if pad:
            words = np.pad(words, ((0, pad), (0, 0)))
            lengths = np.pad(lengths, (0, pad))
            if mask is not None:
                mask = np.pad(mask, ((0, pad), (0, 0)))
        if mask is None:
            mask = zero_mask_words(batch_reads, L)
        gw = jax.make_array_from_process_local_data(sh_rows, words)
        gl = jax.make_array_from_process_local_data(sh_vec, lengths)
        gm = jax.make_array_from_process_local_data(sh_rows, mask)
        part, ovf = count_spectrum_sharded_packed(
            gw, gl, k, capacity, mesh, canonical, length=L, mask=gm
        )
        ovf.copy_to_host_async()
        _resolve()
        if total is None:
            total = part
            pending = (None, part, ovf, None)
        elif total.capacity == part.capacity:
            merged = merge_spectra_fixed(total, part)
            mflag = _overflow_flag(merged.hi)
            mflag.copy_to_host_async()
            pending = (total, part, ovf, mflag)
            total = merged
        else:
            pending = (None, part, ovf, None)
            total = merge_spectra_sized(total, part)
    _resolve()
    if total is None:
        total = Spectrum(
            hi=jnp.full(capacity, SENTINEL, jnp.uint32),
            lo=jnp.full(capacity, SENTINEL, jnp.uint32),
            count=jnp.zeros(capacity, jnp.int32),
            n=jnp.int32(0),
        )
    return total, overflowed


def host_read_slice(n_records: int) -> slice:
    """The record range this host should ingest: contiguous slice of the
    input file(s), pair-aligned (even boundaries) so mates stay on one
    host."""
    import jax

    p, n = jax.process_index(), jax.process_count()
    per = -(-n_records // n)
    per += per % 2  # pair alignment
    start = min(p * per, n_records)
    stop = min(start + per, n_records)
    return slice(start, stop)
