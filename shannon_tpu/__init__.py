"""shannon_tpu — a de novo RNA-seq transcriptome assembler in JAX.

A from-scratch rebuild of the capabilities of the reference assembler
(sreeramkannan/Shannon: information-optimal de novo transcriptome assembly,
Kannan et al. 2016) designed for an accelerator:

  * k-mer counting as a sort/segment-reduce pipeline on device (XLA
    sorts), sharded across devices with a hash all-to-all,
  * error correction (abundance + extension/relative-sibling trimming) as
    vectorized probes into the sorted k-mer spectrum,
  * de Bruijn graph condensation via pointer-jumping on fixed-shape arrays,
  * component partitioning via connected components / label propagation
    (replacing the reference's GPMETIS subprocess),
  * read threading (multibridging) and sparse-flow path decomposition as
    batched device ops (replacing the reference's per-process pool),
  * a pure-Python oracle (`shannon_tpu.oracle`) that defines the exact
    semantics and serves as the parity test anchor, standing in for the
    reference pipeline (reference mount unavailable; see SURVEY.md §0).

Reference layer map: SURVEY.md §2; component inventory: SURVEY.md §3.
"""

__version__ = "0.1.0"

from shannon_tpu.config import AssemblyConfig  # noqa: F401
