"""Batched bit-parallel edit-distance rows: the plain PyTorch forward and
the wrapper of its hand-written CUDA kernel (csrc/edit.cu).

The plain version is a port of bsalign_tpu.ops.edit_jax's
make_edit_forward (Myers' bit-vector step over ±1 difference planes,
bsalign.h:612-1206) to eager torch on batch-minor [NW, B] tensors. Plane
pm is "u == -1", pp is "u == +1"; band position p is bit p % 32 of word
p // 32. torch.uint32 has no shifts, complement or addition, so the words
are carried as int64 holding values in [0, 2**32); the cross-word carry
of the addition is a Kogge-Stone prefix over the word axis. It runs on
any device, one Python step per row, and serves the CPU path and the
tests. On a CUDA device `make_edit_forward` launches the kernel instead,
and never falls back.

Both versions return the same raw outputs, int32 words holding the
uint32 bits: pm, pp [B, T, NW], sbeg [B, T], fin_pm, fin_pp [B, NW] and
scal [B, 4] = (final sbeg, smin, ry, rbeg at the last row). Rows at and
past a pair's tlen are not defined: the kernel skips them, the plain
version computes them from a trajectory the driver pads with zeros, and
nothing reads them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import MODE_EXTEND, MODE_OVERLAP, mode_type

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF
SMIN0 = 0x7FFFFFFF


class EditResult(NamedTuple):
    """Same fields and shapes as bsalign_tpu.ops.edit_jax.EditResult, as
    numpy arrays on the host."""
    pm: np.ndarray      # [T, NW, B] uint32 minus-planes per row
    pp: np.ndarray      # [T, NW, B] uint32 plus-planes per row
    sbeg: np.ndarray    # [T, B] int32 H at band-left boundary per row
    smin: np.ndarray    # [B] best overlap/extend row score
    ry: np.ndarray      # [B] row of best score
    final_score: np.ndarray  # [B] global score (H(qlen-1, tlen-1))
    final_sbeg: np.ndarray   # [B]


class Geometry(NamedTuple):
    """Fixed shape of one forward (the make_edit_forward arguments)."""
    T: int
    NW: int
    mode: int

    @property
    def bw(self) -> int:
        return self.NW * 32


class Operands(NamedTuple):
    """Forward operands on one device, int32 and contiguous."""
    qeq: torch.Tensor     # [4, B, NWQ] query bitmask words
    qlen: torch.Tensor    # [B]
    tseq: torch.Tensor    # [B, T] target codes
    tlen: torch.Tensor    # [B]
    rbegs: torch.Tensor   # [T, B] band start per row
    movxs: torch.Tensor   # [T, B] band move per row


def operands_from_numpy(qeq, qlen, tseq, tlen, rbegs, movxs, *, T: int,
                        device) -> Operands:
    """Put the numpy operands of the edit driver on `device`; the uint32
    query words keep their bits in int32."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    qeq = np.ascontiguousarray(qeq, np.uint32).view(np.int32)
    tseq = np.asarray(tseq, np.int32)
    rbegs = np.asarray(rbegs, np.int32)
    movxs = np.asarray(movxs, np.int32)
    if tseq.shape[1] < T or rbegs.shape[0] < T or movxs.shape[0] < T:
        raise ValueError(f"tseq/rbegs/movxs hold fewer than T={T} rows")
    return Operands(t(qeq), t(np.asarray(qlen, np.int32)), t(tseq[:, :T]),
                    t(np.asarray(tlen, np.int32)), t(rbegs[:T]),
                    t(movxs[:T]))


# ---------------------------------------------------------------- plain ----

def _u32(x):
    """int32 words -> int64 holding the same uint32 value."""
    return x.to(I64) & M32


def _i32(x):
    """int64 holding a uint32 value -> int32 with the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(I32)


def _lowmask(n, NW):
    """Per-word mask of bits with global index < n; n [B] -> [NW, B]."""
    w = torch.arange(NW, device=n.device).view(NW, 1)
    m = (n.view(1, -1).to(I64) - w * 32).clamp(0, 32)
    return (torch.ones_like(m) << m) - 1


def _popcount(x):
    """Bits set in each int64 word holding a uint32 value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _popsum(x):
    return _popcount(x).sum(0)


def _word_dn(x, k):
    """out[w] = x[w - k] along axis 0 (zero fill), static k."""
    if k >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:k]), x[:-k]], 0)


def _take_words(x, idx):
    """out[w, b] = x[idx[w, b], b], 0 where idx is outside x's words."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, x.gather(0, idx.clamp(0, n - 1)), 0)


def _shift_planes(pm, pp, movx, NW, bw):
    """Band shift: new bit p = old bit p+movx; overhang (p >= bw-movx) gets
    u=+1 (striped_seqedit_row_movx, bsalign.h:658-721)."""
    w = torch.arange(NW, device=pm.device).view(NW, 1)
    idx = w + torch.div(movx, 32, rounding_mode="floor").view(1, -1)
    bsh = (movx % 32).view(1, -1).to(I64)

    def sh(x):
        r0 = _take_words(x, idx)
        r1 = _take_words(x, idx + 1)
        return (r0 >> bsh) | ((r1 << (32 - bsh)) & M32)

    keep = _lowmask((bw - movx).clamp(min=0), NW)
    return sh(pm) & keep, (sh(pp) & keep) | (keep ^ M32)


def _eq_words(qeq, tbase, rbeg, NW):
    """Eq of this row's band: the target base's query bitmask from bit
    rbeg on, [NW, B]; words past the query's NWQ read 0. A base code
    outside 1..3 takes plane 0, as in the JAX engine's select chain."""
    _, B, NWQ = qeq.shape
    dev = qeq.device
    v = torch.where((tbase >= 1) & (tbase <= 3), tbase, 0).long()
    eq_t = qeq[v, torch.arange(B, device=dev)].T           # [NWQ, B]
    w = torch.arange(NW + 1, device=dev).view(NW + 1, 1)
    win = _take_words(eq_t, w + torch.div(rbeg, 32, rounding_mode="floor")
                      .view(1, -1))                         # [NW + 1, B]
    bsh = (rbeg % 32).view(1, -1).to(I64)
    return (win[:NW] >> bsh) | ((win[1:] << (32 - bsh)) & M32)


def forward_plain(g: Geometry, ops: Operands):
    """The plain forward on ops' device; returns the raw outputs (module
    docstring)."""
    T, NW, bw = g.T, g.NW, g.bw
    mt = mode_type(g.mode)
    is_overlap = mt == MODE_OVERLAP
    track = is_overlap or mt == MODE_EXTEND
    hp_in = 0 if is_overlap else 1
    qeq = _u32(ops.qeq)
    qlen, tlen = ops.qlen, ops.tlen
    B = qlen.shape[0]
    dev = qeq.device
    pm = torch.zeros((NW, B), dtype=I64, device=dev)
    pp = torch.full((NW, B), M32, dtype=I64, device=dev)
    zi = torch.zeros(B, dtype=I32, device=dev)
    sbeg, ry, rbeg_f = zi, zi, zi
    smin = torch.full((B,), SMIN0, dtype=I32, device=dev)
    pm_o, pp_o, sbeg_o = [], [], []
    for i in range(T):
        active = i < tlen
        rbeg, movx = ops.rbegs[i], ops.movxs[i]
        if is_overlap:
            sbeg_n = zi
            pm_s, pp_s = pm, pp
        else:
            mask = _lowmask(torch.minimum(movx, torch.full_like(movx, bw)), NW)
            dsum = _popsum(pp & mask) - _popsum(pm & mask)
            sbeg_n = (sbeg + torch.where(movx > 0, dsum, 0) + 1).to(I32)
            pm_s, pp_s = _shift_planes(pm, pp, movx, NW, bw)
            full = movx >= bw
            pm_s = torch.where(full, 0, pm_s)
            pp_s = torch.where(full, M32, pp_s)
            zero = movx == 0
            pm_s = torch.where(zero, pm, pm_s)
            pp_s = torch.where(zero, pp, pp_s)

        Eq = _eq_words(qeq, ops.tseq[:, i], rbeg, NW)

        # Myers step; the addition's cross-word carry by Kogge-Stone
        X = Eq | pm_s
        ad = X & pp_s
        s = ad + pp_s
        s0 = s & M32
        gen = s > M32
        prop = s0 == M32
        k = 1
        while k < NW:
            gen = gen | (prop & _word_dn(gen, k))
            prop = prop & _word_dn(prop, k)
            k *= 2
        A = (s0 + _word_dn(gen, 1).to(I64)) & M32
        D0 = (A ^ pp_s) | X
        HP = pm_s | ((D0 | pp_s) ^ M32)
        HN = pp_s & D0
        top = torch.full((1, B), hp_in, dtype=I64, device=dev)
        HPs = ((HP << 1) & M32) | torch.cat([top, HP[:-1] >> 31], 0)
        HNs = ((HN << 1) & M32) | torch.cat([torch.zeros_like(top),
                                             HN[:-1] >> 31], 0)
        pp_n = HNs | ((D0 | HPs) ^ M32)
        pm_n = HPs & D0

        if track:
            inb = _lowmask((qlen - rbeg).clamp(0, bw), NW)
            srow = sbeg_n + _popsum(pp_n & inb) - _popsum(pm_n & inb)
            upd = active & (srow < smin)
            smin = torch.where(upd, srow, smin).to(I32)
            ry = torch.where(upd, i, ry).to(I32)

        pm_o.append(_i32(pm_n))
        pp_o.append(_i32(pp_n))
        sbeg_o.append(sbeg_n)
        pm = torch.where(active, pm_n, pm)
        pp = torch.where(active, pp_n, pp)
        sbeg = torch.where(active, sbeg_n, sbeg)
        rbeg_f = torch.where(active, rbeg, rbeg_f)

    def rows(x):   # T x [NW, B] -> [B, T, NW]
        return torch.stack(x, 0).permute(2, 0, 1).contiguous()

    return dict(pm=rows(pm_o), pp=rows(pp_o),
                sbeg=torch.stack(sbeg_o, 1).contiguous(),
                fin_pm=_i32(pm).T.contiguous(), fin_pp=_i32(pp).T.contiguous(),
                scal=torch.stack([sbeg, smin, ry, rbeg_f], 1).to(I32))


# ---------------------------------------------------------------- wrapper --

def forward_raw(g: Geometry, ops: Operands):
    """Raw forward outputs on the device ops lie on: the hand-written CUDA
    kernel for CUDA tensors (it launches or raises), the plain version for
    CPU tensors."""
    if ops.qeq.is_cuda:
        from . import _cuda
        return _cuda.edit_rows(g, ops)
    return forward_plain(g, ops)


def final_score(g: Geometry, raw, qlen):
    """H(qlen-1, tlen-1) from the frozen final state: sbeg plus the u
    values of the band bits below qlen - rbeg at the last row
    (bsalign.h:1194-1202; edit_pallas.py:319-331)."""
    scal = raw["scal"]
    inb = _lowmask((qlen.to(scal.device) - scal[:, 3]).clamp(0, g.bw), g.NW)
    pops = (_popsum(_u32(raw["fin_pp"]).T & inb)
            - _popsum(_u32(raw["fin_pm"]).T & inb))
    return (scal[:, 0] + pops).to(I32)


def to_result(g: Geometry, raw, qlen) -> EditResult:
    """EditResult on the host from raw outputs on any device."""
    host = {k: v.cpu() for k, v in raw.items()}
    score = final_score(g, host, torch.as_tensor(qlen))
    scal = host["scal"].numpy()

    def planes(x):   # [B, T, NW] int32 -> [T, NW, B] uint32 view
        return x.numpy().view(np.uint32).transpose(1, 2, 0)
    return EditResult(planes(host["pm"]), planes(host["pp"]),
                      host["sbeg"].numpy().T, scal[:, 1].copy(),
                      scal[:, 2].copy(), score.numpy(), scal[:, 0].copy())


def make_edit_forward(T: int, NW: int, mode: int, NWQ: int,
                      win_chunked: bool, *, device):
    """The batched edit forward for T rows and a band of NW*32 bits on
    `device` (same arguments and EditResult as edit_jax.make_edit_forward).

    On a CUDA device it launches the hand-written kernel; on the CPU it
    runs the plain version. `win_chunked` is accepted for the same
    signature and ignored: a full-band batch has a trajectory of zeros.
    NWQ is the query words the driver packed; words past it read as 0."""
    device = torch.device(device)
    g = Geometry(T, NW, mode)

    def forward(qeq, qlen, tseq, tlen, rbegs, movxs):
        ops = operands_from_numpy(qeq, qlen, tseq, tlen, rbegs, movxs, T=T,
                                  device=device)
        if ops.qeq.shape[2] != NWQ:
            raise ValueError(f"qeq holds {ops.qeq.shape[2]} words, not "
                             f"NWQ={NWQ}")
        return to_result(g, forward_raw(g, ops), ops.qlen)

    return forward
