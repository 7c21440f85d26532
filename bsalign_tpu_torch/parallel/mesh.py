"""Data-parallel split of alignment batches over a list of devices (port of
bsalign_tpu.parallel.mesh).

Alignment is embarrassingly parallel across pairs (SURVEY.md §2.6): the only
parallel axis is the batch. A "mesh" here is a list of torch devices. Each
sharded forward cuts every batch-axis operand into contiguous shards, one
per device (uneven batches give shards whose sizes differ by one; nothing
is padded), launches every shard before it waits for any, with one CUDA
stream per device, and joins the outputs in input order. On a CUDA device
a shard runs the hand-written kernel, on the CPU its plain version: the
JAX package's split between its XLA and Pallas forwards collapses into the
one forward of each kernel. A device may appear more than once; its shards
then run one after another on its stream.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import banded8 as K8
from ..ops import edit as KE
from ..ops import pedit as PE


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices to split over: `devices`, or every CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("make_mesh: no devices (no CUDA device is "
                           "available; pass devices=[...] for the CPU)")
    return devs


def shard_bounds(B: int, n: int) -> List[tuple]:
    """Contiguous [lo, hi) of each of n shards of B items; the first
    B % n shards hold one more."""
    per, extra = divmod(B, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + per + (i < extra)
        out.append((lo, hi))
        lo = hi
    return out


class _Streams:
    """One CUDA stream per CUDA device of a mesh; `on(dev)` makes the
    device and its stream current (nothing for the CPU)."""

    def __init__(self, mesh):
        self.s = {d: torch.cuda.Stream(device=d) for d in set(mesh)
                  if d.type == "cuda"}

    @contextlib.contextmanager
    def on(self, dev):
        if dev.type != "cuda":
            yield
            return
        with torch.cuda.device(dev), torch.cuda.stream(self.s[dev]):
            yield


def _take(a, axis: Optional[int], lo: int, hi: int):
    """Rows [lo, hi) of a's batch axis (None: a is not split)."""
    if a is None or axis is None:
        return a
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(lo, hi)
    return a[tuple(idx)]


def _cat_last(parts):
    """Join per-shard outputs along their last (batch) axis: tensors,
    numpy arrays, lists of them, or None."""
    x = parts[0]
    if x is None:
        return None
    if isinstance(x, list):
        return [_cat_last(list(z)) for z in zip(*parts)]
    if isinstance(x, np.ndarray):
        return np.concatenate(parts, axis=-1)
    return torch.cat([p.cpu() for p in parts], -1)


# batch axis of each make_forward operand: qpad [B, QP], qlen [B],
# tseq [B, T], tlen [B], mtx5 (not split), rby [T, B], init_us/es/qs
# [W, WS, B], init_ub [WS+1, B]
_B8_AXES = (0, 0, 0, 0, None, -1, -1, -1, -1, -1)


def make_sharded_forward(T, W, mode, piecewise, gapo1, gape1, gapo2, gape2,
                         nt_max, nt_min, mesh, *, scores_only: bool = False,
                         codes: bool = False):
    """ops.banded8.make_forward with the batch split over the mesh, for
    every emit (codes, planes, none). The returned function takes the same
    operands (and init_reg [8, B] and row0 to resume) and returns the same
    ForwardResult, on the host, in input order."""
    mesh = make_mesh(mesh)
    fwds = {d: K8.make_forward(T, W, mode, piecewise, gapo1, gape1, gapo2,
                               gape2, nt_max, nt_min, scores_only=scores_only,
                               codes=codes, device=d) for d in set(mesh)}
    streams = _Streams(mesh)

    def forward(*args, init_reg=None, row0=0):
        B = len(args[1])
        pending = []
        for dev, (lo, hi) in zip(mesh, shard_bounds(B, len(mesh))):
            if lo == hi:
                continue
            sub = [_take(a, ax, lo, hi) for a, ax in zip(args, _B8_AXES)]
            reg = None if init_reg is None else _take(init_reg, -1, lo, hi)
            with streams.on(dev):
                call, ops, meta = fwds[dev].prepare(*sub, init_reg=reg,
                                                    row0=row0)
                pending.append((dev, call(*ops), meta))
        parts = []
        for dev, outs, meta in pending:
            with streams.on(dev):
                parts.append(fwds[dev].unpack(outs, *meta))
        planes = K8.RowPlanes(*(_cat_last([p.planes[i] for p in parts])
                                for i in range(len(K8.RowPlanes._fields))))
        return K8.ForwardResult(planes, *(
            _cat_last([p[i] for p in parts])
            for i in range(1, len(K8.ForwardResult._fields))))

    return forward


# qeq [4, B, NWQ], qlen [B], tseq [B, T], tlen [B], rbegs / movxs [T, B]
_EDIT_AXES = (1, 0, 0, 0, -1, -1)


def make_sharded_edit_forward(T, NW, mode, NWQ, win_chunked, mesh):
    """ops.edit.make_edit_forward with the batch split over the mesh: same
    operands, same EditResult (numpy, on the host, in input order)."""
    mesh = make_mesh(mesh)
    g = KE.Geometry(T, NW, mode)
    streams = _Streams(mesh)

    def forward(qeq, qlen, tseq, tlen, rbegs, movxs):
        args = (qeq, qlen, tseq, tlen, rbegs, movxs)
        if np.asarray(qeq).shape[2] != NWQ:
            raise ValueError(f"qeq holds {np.asarray(qeq).shape[2]} words, "
                             f"not NWQ={NWQ}")
        pending = []
        for dev, (lo, hi) in zip(mesh, shard_bounds(len(qlen), len(mesh))):
            if lo == hi:
                continue
            sub = [_take(np.asarray(a), ax, lo, hi)
                   for a, ax in zip(args, _EDIT_AXES)]
            with streams.on(dev):
                ops = KE.operands_from_numpy(*sub, T=T, device=dev)
                raw = KE.forward_raw(g, ops)
                if dev.type == "cuda":
                    from ..ops import _cuda
                    raw = _cuda.to_host_async(raw, ops)
                pending.append((dev, raw, sub[1]))
        parts = []
        for dev, raw, ql in pending:
            if dev.type == "cuda":
                from ..ops import _cuda
                raw = _cuda.wait_host(raw)
            parts.append(KE.to_result(g, raw, ql))
        return KE.EditResult(*(_cat_last([p[i] for p in parts])
                               for i in range(len(KE.EditResult._fields))))

    return forward


def sharded_pedit_forward(jobs: List[PE.PeditJob], mesh):
    """ops.pedit.pedit_forward_batch with the jobs split over the mesh:
    per-job (matrix0, matrix1) uint8 numpy arrays in input order."""
    mesh = make_mesh(mesh)
    streams = _Streams(mesh)
    pending = []
    for dev, (lo, hi) in zip(mesh, shard_bounds(len(jobs), len(mesh))):
        if lo == hi:
            continue
        with streams.on(dev):
            pk = PE.pack_jobs(jobs[lo:hi], dev)
            o0, o1 = PE.forward_raw(pk)
            raw = {"o0": o0, "o1": o1}
            if dev.type == "cuda":
                from ..ops import _cuda
                raw = _cuda.to_host_async(raw, pk)
            pending.append((dev, raw, pk, jobs[lo:hi]))
    outs = []
    for dev, raw, pk, shard in pending:
        if dev.type == "cuda":
            from ..ops import _cuda
            raw = _cuda.wait_host(raw)
        h0, h1 = raw["o0"].numpy(), raw["o1"].numpy()
        rowlen = pk.bw + 2
        for j, o in zip(shard, pk.offs.tolist()):
            n = (2 * j.mlen + 2) * rowlen
            outs.append((h0[o:o + n], h1[o:o + n]))
    return outs


def _example_inputs(B, L, bandwidth=128, seed=0):
    """B seeded pairs of L bp at 10% substitutions, packed for the
    banded-8 forward (global, -M 2 -X 6 -O 3 -E 2)."""
    from ..align import pairwise as P
    from ..oracle import banded8 as O
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(B):
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        idx = rng.random(L) < 0.1
        q[idx] = (q[idx] + rng.integers(1, 4, int(idx.sum()))) & 3
        qs.append(q)
        ts.append(t)
    mtx = O.set_score_matrix(2, -6)
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bandwidth)
    us0, es0, qs0, ub0, _ = P._init_state(0, bandwidth, 1, 2, -6, -3, -2,
                                          0, 0, B)
    return (qpad, qlens, tpad, tlens, P._mtx5(mtx), rby, us0, es0, qs0,
            ub0), T, qs, ts


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> None:
    """One sharded step of kernels A and B over n devices at tiny shapes,
    each checked against the unsharded run on the first device. `devices`
    defaults to every CUDA device; fewer than n raises (no undersized
    split is built)."""
    from ..align import editdist as ED
    devs = make_mesh(devices)
    if len(devs) < n_devices:
        raise RuntimeError(f"dryrun_multichip: need {n_devices} devices but "
                           f"only {len(devs)} are available")
    devs = devs[:n_devices]
    B = 4 * n_devices + 1            # one shard holds one pair more
    args, T, qs, ts = _example_inputs(B, 128)
    geo = (T, 128 // 16, 0, 1, -3, -2, 0, 0, 2, -6)
    res = make_sharded_forward(*geo, devs, codes=True)(*args)
    ref = K8.make_forward(*geo, codes=True, device=devs[0])(*args)
    if tuple(res.score.shape) != (B,) or not torch.equal(res.score,
                                                         ref.score):
        raise RuntimeError("dryrun_multichip: the sharded banded-8 scores "
                           "differ from the unsharded run")
    T2, NWQ, eops = ED._pack_bucket(qs, ts, 128, False)
    eres = make_sharded_edit_forward(T2, 4, 0, NWQ, False, devs)(*eops)
    eref = KE.make_edit_forward(T2, 4, 0, NWQ, False, device=devs[0])(*eops)
    if eres.final_score.shape != (B,) or not np.array_equal(
            eres.final_score, eref.final_score):
        raise RuntimeError("dryrun_multichip: the sharded edit scores differ "
                           "from the unsharded run")
