"""Telemetry: cell-updates/s counters and leveled logging (port of
bsalign_tpu.utils.metrics without its profiler hook).

The drivers report work through a process-wide registry under the same
counter names as the JAX package: `banded8_fwd` (DP cells, launch to
results on the host), `e2e_fetch` (bytes copied device to host),
`e2e_traceback` (pairs walked) and `edit_fwd` (edit DP cells, sum of
target lengths x band, operands to results on the host). Verbosity follows the CLI's repeated -v
(BSA_VERBOSE overrides).
"""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict

_VERBOSE = int(os.environ.get("BSA_VERBOSE", "0") or 0)


def set_verbose(level: int) -> None:
    global _VERBOSE
    _VERBOSE = int(level)


def verbose() -> int:
    return _VERBOSE


def log(level: int, msg: str) -> None:
    if _VERBOSE >= level:
        sys.stderr.write(f"[bsa:{level}] {msg}\n")


@dataclass
class Counter:
    cells: float = 0.0
    seconds: float = 0.0
    calls: int = 0

    @property
    def cells_per_s(self) -> float:
        return self.cells / self.seconds if self.seconds else 0.0


_COUNTERS: Dict[str, Counter] = defaultdict(Counter)


def add(kernel: str, cells: float, seconds: float) -> None:
    c = _COUNTERS[kernel]
    c.cells += cells
    c.seconds += seconds
    c.calls += 1


@contextmanager
def timed(kernel: str, cells: float):
    """Wrap an engine call: `with timed("banded8", B*T*bw): ...`"""
    t0 = time.time()
    try:
        yield
    finally:
        add(kernel, cells, time.time() - t0)


def counters() -> Dict[str, Counter]:
    return dict(_COUNTERS)


def reset() -> None:
    _COUNTERS.clear()


def report(out=None) -> None:
    out = out or sys.stderr
    for name, c in sorted(_COUNTERS.items()):
        out.write("[METRIC] %-16s %10.3g cells  %8.3fs  %8.3g cells/s"
                  "  (%d calls)\n" % (name, c.cells, c.seconds,
                                      c.cells_per_s, c.calls))
