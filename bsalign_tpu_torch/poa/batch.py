"""Batched POA: many independent read windows, advanced in lockstep (port of
bsalign_tpu.poa.batch).

Consensus workloads (assembly polishing, read correction) run thousands of
independent windows. Every window's graph work runs on the host, one
window after another; each realignment round's profile DPs of every read
of every window run in one batch on the device (ops/pedit.py): one launch
of the CUDA kernel per round on a CUDA device, the plain version on the
CPU. Per-window results are byte-identical to running each window alone.
"""
from __future__ import annotations

import io
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import pedit as PE
from .core import BSPOA, BSPOAPar


@dataclass
class WindowResult:
    cns: np.ndarray
    qlt: np.ndarray
    alt: np.ndarray
    snvs: str
    msa: Optional[str] = None


def _window_result(g: BSPOA, want_msa: bool) -> WindowResult:
    g.tidy_msa()
    g.call_snvs()
    snv = io.StringIO()
    g.print_snvs("W", snv)
    msa = None
    if want_msa:
        buf = io.StringIO()
        g.print_msa("W", buf)
        msa = buf.getvalue()
    return WindowResult(g.cns.copy(), g.qlt.copy(), g.alt.copy(),
                        snv.getvalue(), msa)


# time split of the most recent run_windows_lockstep call, in seconds per
# window, summed over its rounds: build (the jobs on the host), pack, kernel
# and fetch (ops/pedit.last_timings), apply (tracebacks and graph surgery
# on the host); with the job and launch counts.
last_probe: dict = {}


def _dev_round(pend, device, tm):
    """Run one realignment round for `pend` [(g, ctx, all_)] with every
    window's profile DPs in one batch on `device`. The forward finishes for
    every job before any traceback runs."""
    t0 = time.perf_counter()
    jobs, spans = [], []
    for g, ctx, all_ in pend:
        gj, spec = g._remsa_dev_build(ctx, all_)
        spans.append((g, ctx, spec, all_, len(jobs), len(gj)))
        jobs.extend(gj)
    tm["build_s"] += time.perf_counter() - t0
    mats = []
    if jobs:
        mats = PE.pedit_forward_batch(jobs, device=device)
        for k in ("pack_s", "kernel_s", "fetch_s"):
            tm[k] += PE.last_timings[k]
        tm["njobs"] += len(jobs)
        tm["nbatches"] += 1
    t0 = time.perf_counter()
    # apply runs for every window, even one without jobs: del_msanodes and
    # the nrds bookkeeping must run or later rounds corrupt
    for g, ctx, spec, all_, off, n in spans:
        g._remsa_dev_apply(ctx, spec, mats[off:off + n], all_)
    tm["apply_s"] += time.perf_counter() - t0


def run_windows_lockstep(windows: Sequence[Sequence],
                         par: Optional[BSPOAPar] = None, *, device,
                         want_msa: bool = False) -> List[WindowResult]:
    """POA every window (a list of reads, str or 0-3 code arrays): all
    windows advance through end_bspoa's realignment rounds in lockstep, and
    each round's forward DPs across every window run as one batch on
    `device` (SURVEY.md §7 stage 5: host graph surgery per window, device
    DP batched across windows). With editbw < 0 the rounds run the scalar
    host realignment (remsa_edits) instead, window by window."""
    par = par or BSPOAPar()
    gs = []
    for w in windows:
        g = BSPOA(par, device=device)
        g.beg()
        for s in w:
            if isinstance(s, str):
                g.push(s)
            else:
                g.push_codes(np.asarray(s, np.uint8))
        gs.append(g)
    active = [g.end_begin() for g in gs]
    tm = dict(build_s=0.0, pack_s=0.0, kernel_s=0.0, fetch_s=0.0,
              apply_s=0.0, njobs=0, nbatches=0)
    for i in range(par.realn):
        pend = []       # (graph, ctx, all_) windows with work this round
        for g, a in zip(gs, active):
            if not a:
                continue
            g.msa()
            g.cns_call()
            if par.editbw < 0:
                g.remsa_edits(-par.editbw)
                continue
            ctx = g._remsa_prepare(par.editbw // 2, 1)
            if ctx is not None:
                pend.append((g, ctx, 1 if (i + 1 == par.realn) else 0))
        if pend:
            _dev_round(pend, device, tm)
    for g, a in zip(gs, active):
        if a:
            g.end_finish()
    nw = max(len(gs), 1)
    last_probe.clear()
    last_probe.update({k + "_per_window" if k.endswith("_s") else k:
                       (v / nw if k.endswith("_s") else v)
                       for k, v in tm.items()})
    last_probe["n_windows"] = len(gs)
    return [_window_result(g, want_msa) for g in gs]


def _run_share(args) -> List[WindowResult]:
    """A forked worker's share of run_windows: its windows in lockstep on
    the CPU, on one thread."""
    share, par, want_msa = args
    torch.set_num_threads(1)
    return run_windows_lockstep(share, par, device="cpu", want_msa=want_msa)


def run_windows(windows: Sequence[Sequence], par: Optional[BSPOAPar] = None,
                nproc: int = 0, *, device,
                want_msa: bool = False) -> List[WindowResult]:
    """POA every window on `device`, in lockstep (run_windows_lockstep).

    With nproc > 1 on the CPU, a pool of nproc forked workers runs
    contiguous shares of the windows, each in lockstep; 0/1 runs in this
    process. On a CUDA device nproc > 1 raises ValueError. Results keep
    window order either way."""
    device = torch.device(device)
    if not (nproc and nproc > 1 and len(windows) > 1):
        return run_windows_lockstep(windows, par, device=device,
                                    want_msa=want_msa)
    if device.type != "cpu":
        raise ValueError(
            f"run_windows: nproc={nproc} forks CPU workers, and a CUDA "
            "context does not survive fork; on the card every window's "
            "realignment round is already one launch (use nproc=0)")
    import multiprocessing as mp
    par = par or BSPOAPar()
    n = min(nproc, len(windows))
    cuts = [len(windows) * k // n for k in range(n + 1)]
    tasks = [(list(windows[a:b]), par, want_msa)
             for a, b in zip(cuts, cuts[1:])]
    with mp.get_context("fork").Pool(n) as pool:
        parts = pool.map(_run_share, tasks)
    return [r for part in parts for r in part]
