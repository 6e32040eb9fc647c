"""Synthetic transcriptome + read simulator for property tests and
benchmarks (SURVEY.md §5.2: known isoforms -> simulated reads -> assert
recovery; stands in for the reference's bundled sample-read dataset)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BASES = "ACGT"


def random_seq(rng: np.random.Generator, length: int) -> str:
    return "".join(_BASES[i] for i in rng.integers(0, 4, size=length))


@dataclass
class SimData:
    transcripts: list[str]
    abundances: list[float]
    reads: list[str]
    pairs: bool = False  # reads[2i], reads[2i+1] are mates if True


def simulate_transcripts(
    rng: np.random.Generator,
    n: int = 3,
    length: int = 600,
) -> list[str]:
    return [random_seq(rng, length) for _ in range(n)]


def simulate_isoforms(
    rng: np.random.Generator,
    n_exons: int = 4,
    exon_length: int = 300,
) -> list[str]:
    """Two isoforms sharing flanking exons (the sparse-flow known-answer
    shape: shared prefix/suffix, alternative middle exons)."""
    exons = [random_seq(rng, exon_length) for _ in range(n_exons)]
    iso1 = exons[0] + exons[1] + exons[3]
    iso2 = exons[0] + exons[2] + exons[3]
    return [iso1, iso2]


def simulate_repeat_transcripts(
    rng: np.random.Generator,
    n_pairs: int = 10,
    repeat_length: int = 180,
    flank_length: int = 400,
) -> list[str]:
    """Transcript pairs each sharing a distinct repeat longer than a
    short read but shorter than a paired-end insert: for pair i with
    repeat R_i, t_{2i} = A_i + R_i + B_i and t_{2i+1} = C_i + R_i + D_i
    with unique flanks.  Single-end reads shorter than R_i cannot phase
    the repeat's X-node (both 2-sparse pairings are flow-consistent at
    equal abundance — SF must guess); mates spanning it can (SURVEY.md
    §6 'long-context analog': insert-size bridging resolves repeats
    longer than one read, shorter than the insert)."""
    out: list[str] = []
    for _ in range(n_pairs):
        rep = random_seq(rng, repeat_length)
        a, b, c, d = (random_seq(rng, flank_length) for _ in range(4))
        out.append(a + rep + b)
        out.append(c + rep + d)
    return out


def simulate_gene_isoforms(
    rng: np.random.Generator,
    n_genes: int = 30,
    n_exons: tuple[int, int] = (4, 9),
    exon_length: tuple[int, int] = (80, 400),
    n_isoforms: tuple[int, int] = (2, 5),
) -> tuple[list[str], list[int]]:
    """Splicing-graph transcriptome: each gene is a chain of exons;
    each isoform is an order-preserving subset of its gene's exons that
    keeps the first and last exon as anchors (the common biological
    shape: alternative internal exons under shared terminal exons).

    This is the structure sparse flow exists for (SURVEY.md §1
    "recover every transcript that is in principle recoverable", §5.2
    "two isoforms sharing an exon -> node LP must split 2-sparse"):
    isoforms of one gene share exon sequence, so the condensed graph has
    X-nodes whose flow must be decomposed into the sparsest consistent
    path set — i.i.d. random transcripts (simulate_transcripts) never
    create this (a run on them resolves no SF splits).

    Returns (isoforms, gene_of): flat isoform list + gene id per isoform.
    Isoform subsets within a gene are distinct; single-exon skips make
    pairs that differ by one internal exon (the classic SF known-answer
    at gene scale).
    """
    isoforms: list[str] = []
    gene_of: list[int] = []
    for g in range(n_genes):
        ne = int(rng.integers(n_exons[0], n_exons[1]))
        exons = [
            random_seq(rng, int(rng.integers(exon_length[0], exon_length[1])))
            for _ in range(ne)
        ]
        internal = list(range(1, ne - 1))
        want = int(rng.integers(n_isoforms[0], n_isoforms[1]))
        chosen: set[tuple[int, ...]] = set()
        # first isoform: the full exon chain (every exon expressed once)
        chosen.add(tuple(range(ne)))
        attempts = 0
        while len(chosen) < want and attempts < 20 * want:
            attempts += 1
            if not internal:
                break
            keep = [i for i in internal if rng.random() < 0.6]
            sub = tuple([0, *keep, ne - 1])
            if len(sub) >= 2:
                chosen.add(sub)
        for sub in sorted(chosen):
            isoforms.append("".join(exons[i] for i in sub))
            gene_of.append(g)
    return isoforms, gene_of


def mutate(rng: np.random.Generator, seq: str, error_rate: float) -> str:
    if error_rate <= 0:
        return seq
    codes = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    errs = rng.random(len(codes)) < error_rate
    if errs.any():
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        subs = lut[rng.integers(0, 4, size=int(errs.sum()))]
        codes[errs] = subs
    return codes.tobytes().decode()


def sample_reads(
    rng: np.random.Generator,
    transcripts: list[str],
    abundances: list[float] | None = None,
    coverage: float = 30.0,
    read_length: int = 80,
    error_rate: float = 0.0,
    both_strands: bool = True,
    tile_stride: int = 0,
) -> list[str]:
    """Single-end reads at the given per-transcript coverage (scaled by
    abundance): a deterministic error-free tiling (stride = tile_stride,
    default read_length//3, plus the final start) guarantees every k-mer
    window and junction is covered — recovery failures in tests then mean
    assembler bugs, not sampling gaps — topped up with uniform-position
    random reads to reach the target coverage."""
    from shannon_tpu.io.dna import revcomp_str

    if abundances is None:
        abundances = [1.0] * len(transcripts)
    stride = tile_stride or max(read_length // 3, 1)
    reads: list[str] = []
    for t, ab in zip(transcripts, abundances):
        if len(t) < read_length:
            continue
        last = len(t) - read_length
        tile_starts = list(range(0, last + 1, stride))
        if tile_starts[-1] != last:
            tile_starts.append(last)
        for s in tile_starts:
            reads.append(t[s : s + read_length])
        n_extra = int(np.ceil(coverage * ab * len(t) / read_length)) - len(tile_starts)
        if n_extra > 0:
            starts = rng.integers(0, last + 1, size=n_extra)
            for s in starts:
                r = t[s : s + read_length]
                if both_strands and rng.random() < 0.5:
                    r = revcomp_str(r)
                reads.append(mutate(rng, r, error_rate))
    return reads


def simulate_expression(
    rng: np.random.Generator,
    n_reads: int,
    n_transcripts: int = 500,
    length: int = 1500,
    read_length: int = 100,
    error_rate: float = 0.01,
    paired: bool = False,
    insert_size: int = 300,
) -> tuple[list[str], list[str]]:
    """(transcripts, reads): the benchmark transcriptome — i.i.d.
    transcripts with log-normal abundance (sigma 1, mean 1) — sampled to
    about `n_reads` reads, or about `n_reads` mate pairs when `paired`
    (interleaved as sample_paired_reads returns them)."""
    abund = np.exp(rng.normal(0, 1, n_transcripts))
    abund = (abund / abund.mean()).tolist()
    ts = simulate_transcripts(rng, n=n_transcripts, length=length)
    bases = n_reads * read_length * (2 if paired else 1)
    cov = bases / (n_transcripts * length)
    if paired:
        reads = sample_paired_reads(
            rng, ts, abundances=abund, coverage=cov, read_length=read_length,
            insert_size=insert_size, error_rate=error_rate,
        )
    else:
        reads = sample_reads(
            rng, ts, abundances=abund, coverage=cov, read_length=read_length,
            error_rate=error_rate,
        )
    return ts, reads


def sample_paired_reads(
    rng: np.random.Generator,
    transcripts: list[str],
    abundances: list[float] | None = None,
    coverage: float = 30.0,
    read_length: int = 80,
    insert_size: int = 250,
    error_rate: float = 0.0,
) -> list[str]:
    """Paired-end fragments: mate 1 = fragment start (fwd), mate 2 = RC of
    fragment end; interleaved [L0, R0, L1, R1, ...].

    Same sampling contract as sample_reads: the deterministic tiling
    fragments are ERROR-FREE (every k-mer window and junction is
    guaranteed covered by clean sequence, so recovery failures in tests
    mean assembler bugs, not sampling gaps), and errors apply to the
    random top-up fragments only.  (Until round 5 the tiles were
    mutated too — the paired repeat gate's terminal windows then had a
    single error-carrying read and were UNRECOVERABLE: the '50% exact
    recall stall' was 97.6-99.8%-recovered transcripts missing their
    last few unsequenceable bases, not a phasing failure.)"""
    from shannon_tpu.io.dna import revcomp_str

    if abundances is None:
        abundances = [1.0] * len(transcripts)
    reads: list[str] = []
    for t, ab in zip(transcripts, abundances):
        if len(t) < insert_size:
            continue
        last = len(t) - insert_size
        stride = max(read_length // 3, 1)
        tile = list(range(0, last + 1, stride))
        if tile[-1] != last:
            tile.append(last)
        n_frags = int(np.ceil(coverage * ab * len(t) / (2 * read_length)))
        extra = rng.integers(0, last + 1, size=max(n_frags - len(tile), 0))
        for i, s in enumerate([*tile, *extra.tolist()]):
            frag = t[s : s + insert_size]
            left = frag[:read_length]
            right = revcomp_str(frag[-read_length:])
            if i < len(tile):  # clean tiling anchors (sampling contract)
                reads.append(left)
                reads.append(right)
            else:
                reads.append(mutate(rng, left, error_rate))
                reads.append(mutate(rng, right, error_rate))
    return reads
