"""Reading a torch.profiler Chrome trace of the measured window.

The harness marks the window (`bench.window`) and each call into the
program (`bench.call`) with torch.profiler.record_function, and a driver
marks the program's host phases inside a call in the same way
(`bench.<phase>`, drivers/<name>.py). From the trace this module takes
the device's operations (kernels, copies, memsets), the seconds in which
any of them ran inside the window, and the device's idle time split by
what the host was doing: the innermost span's phase ("call" in a call
outside any phase's span), "harness" outside calls.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
PREFIX = "bench."


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


class Trace:
    """The window's device operations and host spans, times in seconds."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no measured window")
        self.t0 = win[0]["ts"] * 1e-6
        self.t1 = self.t0 + win[0]["dur"] * 1e-6
        self.window_s = self.t1 - self.t0

        def inside(e):
            s = e["ts"] * 1e-6
            return self.t0 <= s < self.t1

        self.ops = [(e["name"], e["ts"] * 1e-6,
                     (e["ts"] + e.get("dur", 0)) * 1e-6)
                    for e in spans if e.get("cat") in DEVICE_CATS
                    and inside(e)]
        self.spans = sorted(
            (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
             e["name"][len(PREFIX):])
            for e in spans if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)
            and e["name"] != WINDOW and inside(e))
        self.busy = _union([(max(a, self.t0), min(b, self.t1))
                            for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy)

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n))

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            tot[name] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        return gaps

    def phases(self) -> List[Tuple[str, float, float]]:
        """The host's phases over the window: at each instant the
        innermost span's (the spans of one thread nest)."""
        out: List[Tuple[str, float, float]] = []
        stack: List[Tuple[float, str]] = []
        t = self.t0

        def upto(x):
            nonlocal t
            if x > t:
                out.append((stack[-1][1] if stack else "harness", t, x))
                t = x

        for a, b, name in sorted(self.spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= a:
                upto(stack[-1][0])
                stack.pop()
            upto(a)
            stack.append((min(b, self.t1), name))
        while stack:
            upto(stack[-1][0])
            stack.pop()
        upto(self.t1)
        return out

    def idle_by_phase(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        gaps = self.idle()
        phases = self.phases()
        i = j = 0                      # both lists sorted and disjoint
        while i < len(phases) and j < len(gaps):
            name, p0, p1 = phases[i]
            g0, g1 = gaps[j]
            tot[name] += _overlap(g0, g1, p0, p1)
            if p1 <= g1:
                i += 1
            else:
                j += 1
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                if v > 0][:n]
