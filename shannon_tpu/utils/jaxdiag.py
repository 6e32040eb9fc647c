"""Compile-shape-churn diagnostics.

Every distinct compiled program costs a compile on a cold start, so the
number of DISTINCT programs a pipeline touches is a first-class
cold-start metric.  This counter rides the jax._src.compiler debug log,
which emits one persistent-compilation-cache hit or miss line with the
program's key per program per process.
"""
from __future__ import annotations

import logging


class ProgramCounter(logging.Handler):
    """Counts distinct compiled programs via persistent-cache key log
    lines.  Attach early (before any jit call) via count_programs()."""

    def __init__(self) -> None:
        super().__init__(level=logging.DEBUG)
        self.keys: set[str] = set()

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        # "Persistent compilation cache hit for ..." / "PERSISTENT
        # COMPILATION CACHE MISS for ...", each ending in key '<key>'
        if "persistent compilation cache" in msg.lower():
            self.keys.add(msg.rsplit("'", 2)[-2])


def count_programs() -> ProgramCounter:
    """Attach a ProgramCounter to the jax compiler logger and return
    it; read `.keys` after the workload to get the distinct count."""
    counter = ProgramCounter()
    lg = logging.getLogger("jax._src.compiler")
    lg.addHandler(counter)
    if lg.level == logging.NOTSET or lg.level > logging.DEBUG:
        lg.setLevel(logging.DEBUG)
    return counter
