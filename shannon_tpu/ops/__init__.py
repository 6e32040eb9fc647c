"""Device (JAX/XLA) compute ops — the device replacements for
the reference's native components (SURVEY.md §3.2):

  * kmers.py / count.py: k-mer extraction + sort/segment-reduce counting
    (replaces Jellyfish's lock-free hash table; SURVEY.md §3.2 row 1)
  * spectrum.py: sorted-spectrum membership/count probes (two-word binary
    search) used by correction and graph construction
  * correction.py: vectorized abundance filter + sibling-ratio pruning

All k-mer values are (hi, lo) uint32 pairs — 2k bits, hi = bits >= 32 —
so no device code needs 64-bit integers (SURVEY.md §8 hard part 1;
ROADMAP C2 weighs one 64-bit key).
"""

from shannon_tpu.ops.kmers import extract_kmers, revcomp_hilo  # noqa: F401
from shannon_tpu.ops.count import Spectrum, count_spectrum, merge_spectra  # noqa: F401
