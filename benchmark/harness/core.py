"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything a cell needs is found by name from BENCHMARK.json: its
configuration (configs/<config>.json, which names its driver
drivers/<driver>.py and its plain reference references/<reference>.py),
its traffic (workloads/<traffic>.json, read by harness/traffic.py) and
each metric's reader (metrics/<metric>.py, `read(ctx)` returning a number
or None when it finds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from . import traffic as traffic_mod

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)          # the checkout: the program's home
FORBIDDEN = ("jax", "jaxlib", "flax", "bsalign_tpu")
KEEP_PER_CALL = 4      # answers kept from each call for the output check
CHECK_PAIRS = 24       # kept answers compared with the reference a run


class NoResult(RuntimeError):
    """The run cannot give a result: it exits non-zero and prints none."""


def load_module(kind: str, name: str, bench: str = BENCH):
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise NoResult(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str, bench: str = BENCH) -> dict:
    path = os.path.join(bench, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise NoResult(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(spec: dict, workload: str, bench: str = BENCH):
    """(cell, configuration, traffic) of a workload named in the spec."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise NoResult(f"BENCHMARK.json names no workload {workload!r}")
    return cell, load_json("configs", cell["config"], bench), \
        load_json("workloads", cell["traffic"], bench)


def metrics_of(spec: dict, cell: dict, trace: bool) -> List[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def check(cfg: dict, calls: List[List], kept: List, seed: int,
          bench: str = BENCH) -> Dict[str, dict]:
    """Compare a seeded sample of the kept answers, with the longest
    alignment among them, with the plain reference's: (answers compared,
    the numbers compared with their limits)."""
    ref = load_module("references", cfg["reference"], bench)
    rng = np.random.default_rng([seed, 3])
    pick = [int(i) for i in rng.permutation(len(kept))[:CHECK_PAIRS]]
    if kept:
        longest = max(range(len(kept)), key=lambda i: (
            kept[i][2] is not None and kept[i][2][0][-1], -i))
        if longest not in pick:
            pick[-1:] = [longest]
    want = {}                 # the calls share the pool's pair objects
    mismatched = missing = 0
    for i in pick:
        ci, j, got = kept[i]
        q, t = calls[ci][j]
        if id(q) not in want:
            want[id(q)] = ref.answer(cfg[cfg["driver"]], q, t)
        if got is None:
            missing += 1
        elif got != want[id(q)]:
            mismatched += 1
    return len(pick), {"mismatched_pairs": {"value": mismatched, "limit": 0},
                       "missing_answers": {"value": missing, "limit": 0}}


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root: str = ROOT,
        driver_hook=None) -> dict:
    """One run; returns the result line's object. Tests of the harness
    alone pass `device="cpu"`, which skips the look for a card and runs
    the program's plain path, `root`, a checkout's copy of
    BENCHMARK.json and benchmark/, and `driver_hook(driver)`, which breaks
    the timed path underneath."""
    import torch
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell, cfg, traffic = load_cell(spec, workload, bench)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    calls = traffic_mod.make_calls(traffic, seed)
    drv = load_module("drivers", cfg["driver"], bench).Driver(cfg, device)
    if driver_hook is not None:
        driver_hook(drv)
    # warm-up: every call has the same shapes (traffic.make_calls); the
    # first builds or loads what the program needs
    drv.call(calls[0])
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    drv.reset_counters()
    rng = np.random.default_rng([seed, 2])
    per = traffic["pairs_per_call"]
    record = SimpleNamespace(call_s=[], call_index=[], bases=0, pairs=0)
    kept = []
    prof = None
    setup_s = time.perf_counter() - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        drv.mark_phases()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        win_span = record_function("bench.window")
        win_span.__enter__()
    t_w0 = time.perf_counter()
    k = 0
    failed = 0
    while True:
        ci = k % len(calls)
        span = None
        if trace:
            span = record_function("bench.call")
            span.__enter__()
        t0 = time.perf_counter()
        out = drv.call(calls[ci])
        t1 = time.perf_counter()
        if span is not None:
            span.__exit__(None, None, None)
        record.call_s.append(t1 - t0)
        record.call_index.append(ci)
        record.bases += traffic_mod.target_bases(calls[ci])
        record.pairs += per
        if len(out) != per:
            failed += per
        for j in rng.choice(per, KEEP_PER_CALL, replace=False):
            j = int(j)
            kept.append((ci, j, drv.answer(out, j) if j < len(out)
                         and out[j] is not None else None))
        k += 1
        if t1 - t_w0 >= seconds:
            break
    window_s = t1 - t_w0
    trace_obj = None
    if trace:
        win_span.__exit__(None, None, None)
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        from .devtrace import Trace
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace_obj = Trace(path)
    if on_card:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"],
               "memory_peak_bytes": max(setup_peak, window_peak)}
    else:
        window_peak = 0
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    found = forbidden_modules()
    if found:
        raise NoResult("modules of JAX or the JAX package are loaded: "
                       + ", ".join(found))
    counters = drv.counters()
    del drv, out
    if on_card:
        torch.cuda.empty_cache()
    ctx = SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, calls=calls,
        call_index=record.call_index, call_s=record.call_s,
        n_calls=len(record.call_s), bases=record.bases, pairs=record.pairs,
        setup_s=setup_s, window_s=window_s, peak_window_bytes=window_peak,
        counters=counters, trace=trace_obj,
        load_module=lambda kind, name: load_module(kind, name, bench))
    metrics = {}
    for m in metrics_of(spec, cell, trace):
        v = load_module("metrics", m["name"], bench).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    n_checked, checks = check(cfg, calls, kept, seed, bench)
    correct = failed == 0 and n_checked > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
    if on_card:
        dev["power_limit"] = power_limit()
    res = {"correct": correct, "attempted": record.pairs, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace_obj is not None:
        res["breakdown"] = {"device_ops": trace_obj.top_ops(10),
                            "idle_gaps": trace_obj.idle_by_phase(10)}
    res["calls"] = ctx.n_calls
    res["call_ms_median"] = 1e3 * statistics.median(record.call_s)
    res["call_ms_quartiles"] = [1e3 * x for x in (
        [min(record.call_s)] + (statistics.quantiles(record.call_s, n=4)
                                if len(record.call_s) > 1
                                else record.call_s * 3)
        + [max(record.call_s)])]
    res["counters"] = counters
    res["pairs_checked"] = n_checked
    res["checks"] = checks        # last: the numbers compared, with limits
    return res
