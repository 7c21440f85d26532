"""Batched remsa pedit profile DP: the plain PyTorch forward and the
wrapper of its hand-written CUDA kernel (csrc/pedit.cu).

The POA engine's realignment rounds (poa/core.py remsa_pedits) realign
each read against its window's MSA column-count profile with an
anti-diagonal, unsigned-8-bit max-match DP (bspoa.h:3856-3896; the host's
bsa_pedit_forward in native/rowops.cpp). A job is one (read, window) pair
with the operands of bsalign_tpu.ops.pedit_pallas.PeditJob; its output is
the pair of uint8 matrices [(2*mlen+2) * (bw+2)] in the host's layout,
whose rows [2*mbeg, 2*mend) the DP writes and the rest stay zero. The
host's traceback (native pedit_traceback) reads them and mutates the
graph.

`pedit_forward_batch` packs a batch of jobs into flat buffers on one
device: the read side of each job, the consensus side once per window,
each as a plane of bases and a plane of counts with the four counts of a
position in one 32-bit word.
On a CUDA device it launches the kernel, once for the whole batch, and
never falls back; on the CPU it runs `forward_plain`, which steps the
anti-diagonals in turn, vectorised over jobs x band cells in int32 with
an explicit min(., 255), and serves the CPU path and the tests.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8
# columns of the int64 job table
JOB_RD, JOB_CN, JOB_OUT, JOB_PAD, JOB_MLEN, JOB_MBEG, JOB_MEND = range(7)
JOB_COLS = 8


class PeditJob:
    """One (read, window) realignment job: the operands of the host's
    bsa_pedit_forward. seqs0 [pad] and mats0 [4, pad] are the read's base
    string and homopolymer counts (its own buffers); seqs1 [pad] and mats1
    [4, pad] the window's reversed consensus and column counts (shared by
    the window's jobs); all uint8 with pad = mlen + bw."""

    __slots__ = ("seqs0", "seqs1", "mats0", "mats1", "mlen", "mbeg", "mend",
                 "bw", "HW")

    def __init__(self, seqs0, seqs1, mats0, mats1, mlen, mbeg, mend, bw, HW):
        self.seqs0 = seqs0
        self.seqs1 = seqs1
        self.mats0 = mats0
        self.mats1 = mats1
        self.mlen = mlen
        self.mbeg = mbeg
        self.mend = mend
        self.bw = bw
        self.HW = HW


class Packed(NamedTuple):
    """A batch of jobs on one device."""
    rd: torch.Tensor      # uint8, per job seqs0 (pad bytes)
    cn: torch.Tensor      # uint8, per window seqs1 (pad bytes)
    rdm: torch.Tensor     # uint8, per job mats0 by position, 4 counts each
    cnm: torch.Tensor     # uint8, per window mats1 likewise (4 x offsets)
    jobs: torch.Tensor    # int64 [J, 8]: the JOB_* columns
    bw: int
    HW: int
    total: int            # bytes of each flat output matrix
    offs: np.ndarray      # int64 [J] output offset of each job


def pack_jobs(jobs: List[PeditJob], device) -> Packed:
    """Flatten the jobs' operands onto `device`. A window's consensus side
    (the same seqs1/mats1 arrays) is stored once."""
    bw, HW = jobs[0].bw, jobs[0].HW
    if any(j.bw != bw or j.HW != HW for j in jobs):
        raise ValueError("pedit jobs of one batch must share bw and HW")
    rowlen = bw + 2
    tab = np.zeros((len(jobs), JOB_COLS), np.int64)
    rd, cn, rdm, cnm, wins = [], [], [], [], {}
    rd_off = cn_off = out_off = 0
    for k, j in enumerate(jobs):
        pad = len(j.seqs0)
        if j.mats0.shape != (4, pad) or len(j.seqs1) != pad \
                or j.mats1.shape != (4, pad):
            raise ValueError("pedit job planes must all be `pad` long")
        key = (id(j.seqs1), id(j.mats1))
        if key not in wins:
            wins[key] = cn_off
            cn.append(np.asarray(j.seqs1, np.uint8))
            cnm.append(np.asarray(j.mats1, np.uint8).T.ravel())
            cn_off += pad
        rd.append(np.asarray(j.seqs0, np.uint8))
        rdm.append(np.asarray(j.mats0, np.uint8).T.ravel())
        tab[k] = (rd_off, wins[key], out_off, pad, j.mlen, j.mbeg, j.mend, 0)
        rd_off += pad
        out_off += (2 * j.mlen + 2) * rowlen

    def put(a):
        return torch.as_tensor(np.concatenate(a), device=device)
    return Packed(put(rd), put(cn), put(rdm), put(cnm), put([tab]), bw, HW,
                  out_off, tab[:, JOB_OUT].copy())


def forward_plain(pk: Packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward on pk's device: both flat uint8 output matrices,
    zero outside the rows each job writes."""
    dev = pk.rd.device
    bw, HW, rowlen = pk.bw, pk.HW, pk.bw + 2
    rd, cn = pk.rd.to(I32), pk.cn.to(I32)
    rdm, cnm = pk.rdm.to(I32), pk.cnm.to(I32)
    (rd_off, cn_off, out_off, pad, mlen, mbeg, mend) = (
        pk.jobs[:, c].view(-1, 1) for c in range(7))
    nsteps = (2 * (mend - mbeg) - 1).clamp(min=1)
    # one spare row at the end takes the writes of finished jobs
    out0 = torch.zeros(pk.total + rowlen, dtype=U8, device=dev)
    out1 = torch.zeros(pk.total + rowlen, dtype=U8, device=dev)
    col = torch.arange(rowlen, device=dev, dtype=I64).view(1, -1)
    i = torch.arange(bw, device=dev, dtype=I64).view(1, -1)
    row0 = out_off + 2 * mbeg * rowlen                       # [J, 1]
    prev0 = torch.where(col == HW, 255, 0).to(I32).expand(len(row0), -1)
    prev1 = torch.where(col == HW + 1, 255, 0).to(I32).expand(len(row0), -1)
    out0[(row0 + col).view(-1)] = prev0.reshape(-1).to(U8)
    out1[(row0 + col).view(-1)] = prev1.reshape(-1).to(U8)
    zero = torch.zeros((), dtype=I32, device=dev)
    for s in range(int(nsteps.max())):
        dirn = s & 1
        ix = mbeg + (s + 1) // 2 + i                          # [J, bw]
        iy = mlen - 1 - (mbeg + s // 2) + i
        okx = ix < pad
        oky = (iy >= 0) & (iy < pad)
        ixc = torch.minimum(ix, pad - 1)
        iyc = iy.clamp(min=0).minimum(pad - 1)
        rb = torch.where(okx, rd[rd_off + ixc], 4)
        cb = torch.where(oky, cn[cn_off + iyc], zero)
        xs = torch.where((cb < 4) & okx,
                         rdm[4 * (rd_off + ixc) + cb.clamp(max=3)], zero)
        ys = torch.where((rb < 4) & oky,
                         cnm[4 * (cn_off + iyc) + rb.clamp(max=3)], zero)
        if dirn:
            pu, pv = prev0[:, 2:2 + bw], prev1[:, 1:1 + bw]
        else:
            pu, pv = prev0[:, 1:1 + bw], prev1[:, :bw]
        h = torch.maximum(torch.maximum((xs + ys).clamp(max=255), pu), pv)
        c0 = torch.zeros((len(row0), rowlen), dtype=I32, device=dev)
        c1 = torch.zeros_like(c0)
        c0[:, 1:1 + bw] = h - pv
        c1[:, 1:1 + bw] = h - pu
        if dirn:
            c0[:, 0] = 255
        else:
            c1[:, bw + 1] = 255
        row = torch.where(s < nsteps, row0 + (s + 1) * rowlen, pk.total)
        idx = (row + col).view(-1)
        out0[idx] = c0.view(-1).to(U8)
        out1[idx] = c1.view(-1).to(U8)
        prev0, prev1 = c0, c1
    return out0[:pk.total], out1[:pk.total]


def forward_raw(pk: Packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output matrices on the device pk lies on: the hand-written CUDA
    kernel for CUDA tensors (it launches or raises), the plain version for
    CPU tensors."""
    if pk.rd.device.type == "cuda":
        from . import _cuda
        return _cuda.pedit_rows(pk)
    return forward_plain(pk)


# time split of the most recent pedit_forward_batch call (seconds): pack
# (host packing and the copy to the device), kernel (the forward alone: CUDA
# events on a CUDA device, the host clock on the CPU), fetch (the copy of
# both matrices to the host).
last_timings: dict = {}


def pedit_forward_batch(jobs: List[PeditJob], *, device):
    """Run the pedit forward DP of every job in one launch on `device`;
    returns per-job (matrix0, matrix1) uint8 numpy arrays in the host's
    layout ([(2*mlen+2) * (bw+2)] flattened), views of one host buffer."""
    device = torch.device(device)
    t0 = time.perf_counter()
    pk = pack_jobs(jobs, device)
    t1 = time.perf_counter()
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out0, out1 = forward_raw(pk)
        e1.record()
        e1.synchronize()
        kernel_s = e0.elapsed_time(e1) / 1e3
    else:
        out0, out1 = forward_raw(pk)
        kernel_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    h0, h1 = out0.cpu().numpy(), out1.cpu().numpy()
    rowlen = pk.bw + 2
    outs = []
    for j, o in zip(jobs, pk.offs.tolist()):
        n = (2 * j.mlen + 2) * rowlen
        outs.append((h0[o:o + n], h1[o:o + n]))
    last_timings.clear()
    last_timings.update(pack_s=t1 - t0, kernel_s=kernel_s,
                        fetch_s=time.perf_counter() - t2, njobs=len(jobs))
    return outs
