"""Telemetry: cell-updates/s counters, leveled logging and the profiler
trace (port of bsalign_tpu.utils.metrics).

The drivers report work through a process-wide registry under the JAX
package's counter names: `banded8_fwd` (DP cells, launch to results on
the host), `e2e_fetch` (bytes copied device to host), `e2e_traceback`
(pairs walked) and `edit_fwd` (edit DP cells, sum of target lengths x
band, operands to results on the host); and two of the port's own:
`e2e_rowmax` (pairs whose final row the non-global row maximum scanned,
one add a batch) and `e2e_rowmax_taken` (pairs whose end that maximum
moved to the final row; no seconds). In the two-pass long-read mode
(`align/pairwise._twopass_batch`) `e2e_fetch` counts each chunk's codes
and band starts, `e2e_traceback` the resumable walker's host seconds
(one add a launch group, cells = pairs), and three more are its own:
`twopass_score` (DP cells, host seconds from pass 1's first launch until
its scores are read into results, one add a group; it takes the place
of `banded8_fwd` there), `banded8_refwd` (DP cells of a re-forwarded
chunk, the host's wait on it and its fetch, one add a chunk) and
`twopass_launch` (pairs of the group, its wall seconds, one add a
group). Verbosity follows the CLI's
repeated -v (BSA_VERBOSE overrides). `profile_trace` writes a
torch.profiler Chrome trace of a region when BSA_PROFILE_DIR is set.
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


@contextmanager
def profile_trace(device):
    """torch.profiler trace of the wrapped region when BSA_PROFILE_DIR is
    set: a Chrome trace (host activity, and the kernels' timeline when
    `device` is a CUDA device) written to
    $BSA_PROFILE_DIR/trace-<pid>.json at the region's end; no-op
    otherwise."""
    d = os.environ.get("BSA_PROFILE_DIR")
    if not d:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"trace-{os.getpid()}.json")
    log(1, f"writing torch.profiler trace to {path}")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)


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
