"""Batched 8-bit banded striped pairwise DP: the plain PyTorch forward and
the wrapper of its hand-written CUDA kernel (csrc/banded8.cu).

The plain version is a literal port of bsalign_tpu.ops.banded8_jax's
make_forward (bsalign.h:2084-4050) to eager torch on batch-minor
[W, WS, B] int32 tensors, with the int8 saturating arithmetic emulated in
int32, plus the packed traceback-code emission and the resume registers of
the Pallas kernel (banded8_pallas.calc_codes, make_forward.prepare). It
runs on any device, one Python step per stripe, and serves the CPU path
and the tests. On a CUDA device `make_forward` launches the kernel
instead, and never falls back.

A forward emits one of three kinds of per-row output (`Geometry.emit`):
"codes" (packed traceback codes, piecewise 0/1), "planes" (the int8
u/e/q difference planes and stripe anchors that backcal reads) or "none"
(scores only). Every emit also returns the final planes, anchors and the
[8, B] register, from which a later call resumes at global row `row0`.

Rows past a pair's tlen freeze its state: the band does not move, the
row's codes, planes and anchors are 0 and its begs entry repeats the
frozen rbeg. The kernel emits the same, so the two versions agree on
every word.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import (MODE_GLOBAL, MODE_OVERLAP, SCORE_EPI8_MAX,
                         SCORE_EPI8_MIN, SCORE_MIN, WORDSIZE, mode_type)

WS = WORDSIZE  # 16
I32 = torch.int32
MIN8 = SCORE_EPI8_MIN  # -63
NEGK = -(1 << 30)      # "no predecessor": never satisfies a score identity
CODES_CAP_BYTES = 4 << 30   # largest codes buffer one launch may hold
EMITS = ("codes", "planes", "none")


class RowPlanes(NamedTuple):
    us: Optional[torch.Tensor]     # [T, W*WS, B] int8 (planes mode only)
    es: Optional[torch.Tensor]     # [T, W*WS, B] int8 or None
    qs: Optional[torch.Tensor]
    ubegs: Optional[torch.Tensor]  # [T, WS+1, B] int32 (planes mode only)
    begs: Optional[torch.Tensor]   # [T, B] int32 (None in none mode)
    # packed 4-bit traceback codes [T, ceil(W/8), WS, B] int32, 8 cells
    # per word along the stripe axis (bsalign_tpu/align/btcodes.py)
    codes: Optional[torch.Tensor] = None


class ForwardResult(NamedTuple):
    planes: RowPlanes
    score: torch.Tensor   # [B] (GLOBAL: corner score; else best-so-far)
    qe: torch.Tensor      # [B]
    te: torch.Tensor      # [B]
    final_us: torch.Tensor     # [W, WS, B] int32 (state at last active row)
    final_ubegs: torch.Tensor  # [WS+1, B] int32
    final_rbeg: torch.Tensor   # [B] int32
    final_planes: object = None   # [us, es?, qs?] each [W, WS, B] int32
    final_reg: object = None      # [8, B] int32: rbeg, mov, 0, best score,
                                  # best qe, best te, 0, 0


class Geometry(NamedTuple):
    """Fixed shape and costs of one forward (the make_forward arguments).
    T counts the rows of this call; emit is one of EMITS."""
    T: int
    W: int
    mode: int
    piecewise: int
    gapo1: int
    gape1: int
    gapo2: int
    gape2: int
    nt_max: int
    nt_min: int
    emit: str

    @property
    def BW(self) -> int:
        return self.W * WS

    @property
    def CPW(self) -> int:
        return -(-self.W // 8)

    def overhang(self):
        """(D_OH, C_OH): length of the first overhang gap piece and the
        int8-wrapped cost of the overhang's first cell (bsalign.h:2357-2390)."""
        if self.piecewise == 2:
            d = (self.gapo1 - self.gapo2) // (self.gape2 - self.gape1)
            c0 = (min(self.nt_min, self.gapo2 + self.gape2) - 1 - self.nt_max
                  + (self.gapo2 + self.gape2))
        else:
            d = self.BW + 1
            c0 = (min(self.nt_min, self.gapo1 + self.gape1) - 1 - self.nt_max
                  + (self.gapo1 + self.gape1))
        return d, ((c0 + 128) & 0xFF) - 128


class State(NamedTuple):
    """Forward operands on one device, int32 and contiguous. tseq and rby
    hold this call's rows; global row row0 + r is local row r."""
    qpad: torch.Tensor    # [B, QP] query codes, 4-padded
    qlen: torch.Tensor    # [B]
    tseq: torch.Tensor    # [B, T] target codes
    tlen: torch.Tensor    # [B]
    rbz: torch.Tensor     # [B] global steering stride 2*max(tlen//qlen, 1)
    mtx5: torch.Tensor    # [5, 4]
    rby: torch.Tensor     # [T, B] diagonal targets
    us: torch.Tensor      # [W, WS, B] init planes
    es: Optional[torch.Tensor]
    qs: Optional[torch.Tensor]
    ub: torch.Tensor      # [WS+1, B] init stripe anchors
    reg: torch.Tensor     # [8, B] init registers (ForwardResult.final_reg)
    row0: int = 0         # global index of this call's first row


def fresh_reg(B: int) -> np.ndarray:
    """The registers of a run's first row: band at 0, no move, no best
    score yet (slot 3 at SCORE_MIN, as banded8_pallas prepare sets it)."""
    reg = np.zeros((8, B), np.int32)
    reg[3] = SCORE_MIN
    return reg


def state_from_numpy(qpad, qlen, tseq, tlen, mtx5, rby, init_us, init_es,
                     init_qs, init_ub, init_reg=None, row0: int = 0, *,
                     T: int, device) -> State:
    """Put the operands of bsalign_tpu's _pack_batch/_init_state (numpy
    arrays, or tensors on any device) on `device` in the layout both
    forward versions read. init_reg and row0 resume a run from an earlier
    call's final registers (None: fresh_reg); slot 2 is not read. rbz is
    computed here on the host, like the Pallas wrapper does for padded
    pairs."""
    def t(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=I32).contiguous()
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)
    qlen_np = np.asarray(qlen, np.int32)
    tlen_np = np.asarray(tlen, np.int32)
    rbz = 2 * np.maximum(tlen_np // np.maximum(qlen_np, 1), 1)
    tseq_np = np.asarray(tseq, np.int32)
    rby_np = np.asarray(rby, np.int32)
    if tseq_np.shape[1] < T or rby_np.shape[0] < T:
        raise ValueError(f"tseq/rby hold fewer than T={T} rows")
    reg = fresh_reg(len(qlen_np)) if init_reg is None else init_reg
    return State(t(qpad), t(qlen_np), t(tseq_np[:, :T]), t(tlen_np), t(rbz),
                 t(mtx5), t(rby_np[:T]), t(init_us), t(init_es), t(init_qs),
                 t(init_ub[:WS + 1]), t(reg), int(row0))


def query_bytes(qpad: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's query operand: qpad [B, QP] as uint8 [B, QPU],
    QPU = QP rounded up to 16 plus 16, codes of 4 and above as 4 and every
    byte past QP 4 (all of them score MIN8, as past the padding in
    _qprof_row). The kernel reads each lane's window as aligned words."""
    B, QP = qpad.shape
    qb = torch.full((B, -(-QP // 16) * 16 + 16), 4, dtype=torch.uint8,
                    device=qpad.device)
    qb[:, :QP] = qpad.clamp(0, 4)
    return qb


# ---------------------------------------------------------------- plain ----

def _adds8(a, b):
    return (a + b).clamp_(-128, 127)


def _subs8(a, b):
    return (a - b).clamp_(-128, 127)


def _wrap8(x):
    """C narrowing int->int8 (wraps)."""
    return ((x + 128) & 0xFF) - 128


def _getscore_vec(us, ub, pos):
    """Absolute H at natural band position pos per pair (bsalign.h:3187).
    us [W, WS, B], ub [WS+1, B], pos [B] >= 0 -> [B] int32. Past the band
    (pos // W >= WS) the stripe sum is 0 and the anchor is ub[WS] at
    pos // W == WS, else 0, as in banded8_jax._getscore_vec."""
    W, _, B = us.shape
    x = pos % W
    y = pos // W
    b = torch.arange(B, device=us.device)
    cums = torch.cumsum(us, 0, dtype=I32)
    s = torch.where(y < WS, cums[x, y.clamp(max=WS - 1), b], 0)
    u = torch.where(y <= WS, ub[y.clamp(max=WS), b], 0)
    return (u + s).to(I32)


def _movx(us, es, qs, ub, movx, g: Geometry):
    """Vectorized banded_striped_epi8_seqalign_piecex_row_movx
    (bsalign.h:2244-2392) for per-pair movx >= 0, including the full reset
    at movx >= bandwidth."""
    W, BW = g.W, g.BW
    dev = us.device
    B = us.shape[-1]
    cyc = movx // W
    mov = movx % W
    div = W - mov
    is_zero = movx == 0
    is_full = movx >= BW
    i_ax = torch.arange(W, device=dev).view(W, 1, 1)
    j_ax = torch.arange(WS, device=dev).view(1, WS, 1)
    # new[i, j] = old[i + mov, j + cyc] for i < div, old[i - div, j + cyc + 1]
    # after; lanes shifted past the last one read 0
    src_i = (i_ax + mov) % W
    src_j = j_ax + cyc + (i_ax >= div).to(I32)
    valid = src_j < WS
    idx = (src_i * WS + src_j.clamp(max=WS - 1)).reshape(BW, B).long()

    def shift(p):
        if p is None:
            return None
        moved = p.reshape(BW, B).gather(0, idx).reshape(W, WS, B)
        return torch.where(is_zero, p, torch.where(valid, moved, 0))

    us_n, es_n, qs_n = shift(us), shift(es), shift(qs)

    # ubegs: ubt[j] = ubegs[j] + sum_{i<mov} us[i, j]; new ub[k] = ubt[k+cyc]
    # for k < WS - cyc, else ubegs[WS]
    ubt = ub[:WS] + (us * (i_ax < mov).to(I32)).sum(0, dtype=I32)
    k = torch.arange(WS + 1, device=dev).view(WS + 1, 1)
    gk = ubt.gather(0, (k + cyc).clamp(max=WS - 1).expand(WS + 1, B).long())
    ub_n = torch.where(k < WS - cyc, gk, ub[WS])
    ub_n = torch.where(is_zero, ub, ub_n)

    # mimic-insertion overhang over natural positions p >= BW - movx
    d, c0 = g.overhang()
    p = j_ax * W + i_ax                                # [W, WS, 1]
    p0 = BW - movx
    fill = torch.where(p < p0 + d, g.gape1, g.gape2)
    fill = torch.where(p == p0, c0, fill)
    us_n = torch.where((p >= p0) & ~is_zero, fill, us_n)
    # ubegs[b+1] += running overhang cost at the end of lane block b
    rel = (torch.arange(WS, device=dev).view(WS, 1) + 1) * W - 1 - p0
    n1 = rel.clamp(0, d - 1)
    n2 = (rel - d + 1).clamp(min=0)
    adj = torch.where((rel >= 0) & ~is_zero, c0 + g.gape1 * n1 + g.gape2 * n2,
                      0)
    ub_n = torch.cat([ub_n[:1], ub_n[1:] + adj], 0)

    # movx >= bandwidth: full reset (bsalign.h:2253-2259)
    us_n = torch.where(is_full, 0, us_n)
    es_n = None if es_n is None else torch.where(is_full, 0, es_n)
    qs_n = None if qs_n is None else torch.where(is_full, 0, qs_n)
    ub_n = torch.where(is_full, SCORE_MIN, ub_n)
    return us_n.to(I32), es_n, qs_n, ub_n.to(I32)


def _fpen(f, ub, gape, W):
    """Active F-loop over lane heads (bsalign.h:2639-2652), with the int8
    wrap on stores. f [WS, B] (pass-1 lane ends), ub [WS+1, B]."""
    t = W * gape
    out = [torch.full_like(f[0], MIN8)]
    s = t + MIN8 - (ub[1] - ub[0])
    for j in range(1, WS):
        fi = f[j - 1]
        fi2 = torch.where(fi < s, _wrap8(s), fi)
        out.append(fi2)
        s = t + fi2 - (ub[j + 1] - ub[j])
    return torch.stack(out, 0)


def _qprof_row(qpad, rbeg, tbase, mtx5, W):
    """Query scores for the current row: [W+1, WS, B] int32 with
    value(i, j, b) = mtx5[qpad[b, rbeg_b + i + j*W], tbase_b]; query codes
    of 4 and above (and positions past the padding) score MIN8."""
    B, QP = qpad.shape
    dev = qpad.device
    off = (torch.arange(W + 1, device=dev).view(W + 1, 1)
           + torch.arange(WS, device=dev).view(1, WS) * W)      # [W+1, WS]
    pos = rbeg.view(1, 1, B) + off.unsqueeze(-1)
    inb = pos < QP
    b = torch.arange(B, device=dev).view(1, 1, B)
    code = qpad.reshape(-1)[(b * QP + pos.clamp(max=QP - 1)).long()]
    code = torch.where(inb, code, 4)
    sc = mtx5.reshape(-1)[(code.clamp(max=3) * 4 + tbase.view(1, 1, B)).long()]
    return torch.where(code < 4, sc, MIN8).to(I32)


def _row_cal(g: Geometry, qprof_row, us0, es0, qs0, ub0, rh):
    """One batched row update (bsalign.h:2520-2652); returns the new
    us/es/qs planes and stripe anchors."""
    pw, W = g.piecewise, g.W
    GapE = g.gape1
    GapOE = g.gapo1 + g.gape1
    GapP = g.gape2
    GapQP = g.gapo2 + g.gape2
    GapOQ = max(-128, min(127, GapOE - GapQP))
    if pw == 0:
        t0 = us0[0, 0] + GapE
    elif pw == 1:
        t0 = us0[0, 0] + es0[0, 0]
    else:
        t0 = us0[0, 0] + torch.maximum(es0[0, 0], qs0[0, 0])
    h0 = (rh - ub0[0]) + qprof_row[0, 0]
    h0 = torch.where(h0 >= t0, h0.clamp(max=SCORE_EPI8_MAX), MIN8)
    h0 = _wrap8(h0)  # mm_insert_epi8 narrowing
    qp0 = torch.cat([h0[None], qprof_row[0, 1:]], 0)   # [WS, B]
    minf = torch.full_like(qp0, MIN8)

    # --- pass 1: f (and g) entering each lane block ---
    h, f, gg = qp0, minf, minf
    for x in range(W):
        u = us0[x]
        if pw == 0:
            e = _adds8(u, GapE)
            h = torch.maximum(torch.maximum(e, h), f)
            f = _subs8(_adds8(h, GapE), u)
        elif pw == 1:
            e = _adds8(es0[x], u)
            h = torch.maximum(torch.maximum(e, h), f)
            f = _adds8(f, GapE)
            h = _adds8(h, GapOE)
            f = _subs8(torch.maximum(f, h), u)
        else:
            e = _adds8(es0[x], u)
            q = _adds8(qs0[x], u)
            h = torch.maximum(torch.maximum(torch.maximum(e, h), q), f)
            h = torch.maximum(gg, h)
            f = _adds8(f, GapE)
            h = _adds8(h, GapOE)
            f = _subs8(torch.maximum(f, h), u)
            gg = _adds8(gg, GapP)
            h = _subs8(h, GapOQ)
            gg = _subs8(torch.maximum(gg, h), u)
        h = qprof_row[x + 1]
    f = _fpen(f, ub0, GapE, W)
    if pw == 2:
        gg = _fpen(gg, ub0, GapP, W)

    # --- pass 2 ---
    z = qp0
    v = torch.zeros_like(qp0)
    us1, es1, qs1 = [], [], []
    for x in range(W):
        u = us0[x]
        if pw == 0:
            e = _adds8(u, GapE)
            h = torch.maximum(torch.maximum(e, z), f)
            us1.append(_subs8(h, v))
            v = _subs8(h, u)
            f = _subs8(_adds8(h, GapE), u)
        elif pw == 1:
            e = _adds8(es0[x], u)
            h = torch.maximum(torch.maximum(e, z), f)
            us1.append(_subs8(h, v))
            v = _subs8(h, u)
            e = _subs8(_adds8(e, GapE), h)
            es1.append(e.clamp(min=GapOE))
            f = _adds8(f, GapE)
            h = _adds8(h, GapOE)
            f = _subs8(torch.maximum(f, h), u)
        else:
            e = _adds8(es0[x], u)
            h = torch.maximum(e, z)
            q = _adds8(qs0[x], u)
            h = torch.maximum(torch.maximum(torch.maximum(q, h), f), gg)
            us1.append(_subs8(h, v))
            v = _subs8(h, u)
            e = _subs8(_adds8(e, GapE), h)
            es1.append(e.clamp(min=GapOE))
            q = _subs8(_adds8(q, GapP), h)
            qs1.append(q.clamp(min=GapQP))
            f = _adds8(f, GapE)
            h = _adds8(h, GapOE)
            f = _subs8(torch.maximum(f, h), u)
            gg = _adds8(gg, GapP)
            h = _subs8(h, GapOQ)
            gg = _subs8(torch.maximum(gg, h), u)
        u_l, h_l = u, h
        z = qprof_row[x + 1]
    if pw == 0:
        h_fin = h_l
    elif pw == 1:
        h_fin = _subs8(h_l, GapOE)
    else:
        h_fin = _subs8(h_l, GapQP)

    # --- tail codes (bsalign.h:2618-2636) ---
    us1 = torch.stack(us1, 0)
    v2 = _subs8(h_fin, u_l)                             # [WS, B]
    v3 = torch.cat([torch.zeros_like(v2[:1]), v2[:-1]], 0)
    us1_0 = _subs8(us1[0], v3)
    ub1 = torch.cat([(ub0[0] + us1_0[0])[None], ub0[1:] + v2], 0)
    us1_0[0] = 0
    us1[0] = us1_0
    es1 = torch.stack(es1, 0) if pw >= 1 else None
    qs1 = torch.stack(qs1, 0) if pw == 2 else None
    return us1, es1, qs1, ub1


def _band_mov(ub, i, qoff, qlen, W):
    """Adaptive band steering decision (bsalign.h:3331-3349)."""
    BW = W * WS
    noisy = (ub[1:] - ub[:-1]).abs().sum(0, dtype=I32)
    noisy = torch.clamp(noisy // WS // W * WS // 2, min=WS)
    mov = torch.where(ub[0] + noisy < ub[WS], 2,
                      torch.where(ub[0] > ub[WS] + noisy, 0, 1))
    if i <= BW // 4:
        mov = torch.zeros_like(mov)
    return torch.where(qoff + BW >= qlen, 0, mov).to(I32)


def _u32_div_plus1(num, den):
    """int32(uint32(1 + uint32(num) // uint32(den))): C's unsigned division
    at bsalign.h:4012, wrapped back to int32 like the JAX engine's cast."""
    m = 0xFFFFFFFF
    r = (1 + (num.long() & m) // (den.long() & m)) & m
    return (((r + (1 << 31)) & m) - (1 << 31)).to(I32)


def _nat(a, W):
    """[W, WS, B] stripe layout -> [BW, B] natural band order p = y*W + x."""
    return a.permute(1, 0, 2).reshape(W * WS, a.shape[-1])


def calc_codes(g: Geometry, us0, es0, ub0, us1, es1, ub1, qp, rh_move, inner,
               mov_eff, rbeg_n, qlen):
    """Per-cell m/d/eo/fo decision bits (btcodes.codes_from_rows), packed 8
    nibbles per int32 word along x: [CPW, WS, B] (port of
    banded8_pallas.calc_codes, habs_of and flat_shift1).

    us0/es0/ub0 are the previous row's planes already shifted into this
    row's frame; qp [W, WS, B] are the row's query scores."""
    W, BW = g.W, g.BW
    GapE = g.gape1
    GapOE = g.gapo1 + g.gape1
    B = us1.shape[-1]
    dev = us1.device
    p = torch.arange(BW, device=dev).view(BW, 1)
    # absolute H per cell: anchor + prefix sum of the lane's differences
    hprev = _nat(torch.cumsum(us0, 0, dtype=I32) + ub0[:WS][None], W)
    habs = _nat(torch.cumsum(us1, 0, dtype=I32) + ub1[:WS][None], W)
    # diagonal predecessor H(i-1, p-1); cell 0 takes the row head
    diag0 = torch.where(mov_eff > 0, rh_move,
                        torch.where(rbeg_n > 0, ub0[0], inner))
    diag0 = torch.where(mov_eff > BW, NEGK, diag0)
    diag = torch.cat([diag0.view(1, B).to(I32), hprev[:-1]], 0)
    ok = p <= BW - mov_eff
    delta = habs - diag
    m = (delta == _nat(qp, W)) & ok
    if g.piecewise >= 1:
        usum = _nat(us0 + es0, W)
    else:
        usum = _nat(us0, W) + GapOE
    # x == BW: predecessor u/e fall just past the band -> (0, GapOE)
    usum = torch.where(p == BW - mov_eff, GapOE, usum)
    d = (delta == usum) & ok
    if g.piecewise >= 1:
        eo = (_nat(es1, W) == GapOE).to(I32) << 2
    else:
        eo = torch.full_like(habs, 4)    # linear gaps: every E chain is length 1
    # F-open: telescoped running max along the row
    base = habs + (GapOE - GapE) - p.to(I32) * GapE
    racc = torch.cummax(base, 0).values
    fo = torch.cat([torch.zeros_like(m[:1]), racc[:-1] == base[:-1]], 0)
    code = m.to(I32) | (d.to(I32) << 1) | eo | (fo.to(I32) << 3)
    code = torch.where(rbeg_n + p < qlen, code, 0)
    # back to [W, WS, B]; pack 8 nibbles per word along x
    code = code.reshape(WS, W, B).permute(1, 0, 2)
    pad = g.CPW * 8 - W
    if pad:
        code = torch.cat([code, code.new_zeros(pad, WS, B)], 0)
    code = code.reshape(g.CPW, 8, WS, B)
    word = code[:, 0]
    for k in range(1, 8):
        word = word | (code[:, k] << (4 * k))
    return word


def forward_plain(g: Geometry, st: State):
    """The plain forward on st's device, over st's T rows from global row
    st.row0. Returns a dict of raw outputs: codes [T, CPW, WS, B] (codes
    emit) or planes us/es/qs [T, BW, B] int8 and ubegs [T, WS+1, B]
    (planes emit), begs [T, B] (both), and in every emit the final planes,
    anchors and registers."""
    W, BW, T = g.W, g.BW, g.T
    mt = mode_type(g.mode)
    pw = g.piecewise
    if g.emit not in EMITS:
        raise ValueError(f"emit must be one of {EMITS}, got {g.emit!r}")
    if g.emit == "codes" and pw == 2:
        raise ValueError("codes mode covers piecewise 0/1 only")
    B = st.qpad.shape[0]
    dev = st.qpad.device
    us, es, qs, ub = st.us, st.es if pw >= 1 else None, \
        st.qs if pw == 2 else None, st.ub
    qlen, tlen = st.qlen, st.tlen
    zi = torch.zeros(B, dtype=I32, device=dev)
    rbeg, mov = st.reg[0], st.reg[1]
    best_s, best_qe, best_te = st.reg[3], st.reg[4], st.reg[5]
    codes_o, begs_o = [], []
    us_o, es_o, qs_o, ub_o = [], [], [], []
    for r in range(T):
        i = st.row0 + r          # global row; tseq and rby hold local rows
        active = i < tlen
        cond_move = (mov > 0) & (rbeg + BW < qlen)
        mov_eff = torch.where(
            active & cond_move,
            torch.minimum(mov, (qlen - (rbeg + BW)).clamp(min=0)), 0)
        rbeg_n = rbeg + mov_eff
        rh_move = _getscore_vec(us, ub, (mov_eff - 1).clamp(min=0))
        if mt == MODE_OVERLAP or i == 0:
            inner = 0
        elif pw < 2:
            inner = g.gapo1 + g.gape1 * i
        else:
            inner = max(g.gapo1 + g.gape1 * i, g.gapo2 + g.gape2 * i)
        rh_nomove = torch.where(rbeg > 0, SCORE_MIN, inner).to(I32)
        rh = torch.where(cond_move, rh_move, rh_nomove)

        us0, es0, qs0, ub0 = _movx(us, es, qs, ub, mov_eff, g)
        qprof = _qprof_row(st.qpad, rbeg_n, st.tseq[:, r], st.mtx5, W)
        us1, es1, qs1, ub1 = _row_cal(g, qprof, us0, es0, qs0, ub0, rh)

        # adaptive band + global diagonal steering (bsalign.h:4006-4021)
        rbx = _band_mov(ub1, i, rbeg_n, qlen, W)
        if mt == MODE_GLOBAL:
            rbz = st.rbz
            m1 = tlen - i - 1
            D = qlen + rbz - 1 - rbeg_n - BW
            quick = (D >= 0) & (m1 <= torch.div(D, rbz, rounding_mode="floor"))
            movq = _u32_div_plus1(qlen - (rbeg_n + BW), m1.clamp(min=1))
            rby_i = st.rby[r]
            mov_n = torch.where(
                quick, movq,
                torch.where(rbeg_n < rby_i - BW, rbx + 1,
                            torch.where(rbeg_n > rby_i, (rbx - 1).clamp(min=0),
                                        rbx)))
        else:
            mov_n = rbx

        # best-end tracking for overlap/extend (bsalign.h:4023-4032)
        if mt != MODE_GLOBAL:
            reach = rbeg_n + BW >= qlen
            sc = _getscore_vec(us1, ub1, (qlen - 1 - rbeg_n).clamp(min=0))
            upd = active & reach & (sc > best_s)
            best_s = torch.where(upd, sc, best_s)
            best_qe = torch.where(upd, qlen - 1, best_qe)
            best_te = torch.where(upd, i, best_te)

        if g.emit == "codes":
            cw = calc_codes(g, us0, es0, ub0, us1, es1, ub1, qprof[:W],
                            rh_move, inner, mov_eff, rbeg_n, qlen)
            codes_o.append(torch.where(active, cw, 0).to(I32))
        elif g.emit == "planes":
            for out, p in ((us_o, us1), (es_o, es1), (qs_o, qs1)):
                if p is not None:
                    out.append(torch.where(active, p, 0).to(torch.int8)
                               .reshape(BW, B))
            ub_o.append(torch.where(active, ub1, 0).to(I32))
        if g.emit != "none":
            begs_o.append(rbeg_n)

        # freeze inactive pairs
        us = torch.where(active, us1, us)
        es = None if es is None else torch.where(active, es1, es)
        qs = None if qs is None else torch.where(active, qs1, qs)
        ub = torch.where(active, ub1, ub)
        rbeg = torch.where(active, rbeg_n, rbeg)
        mov = torch.where(active, mov_n, mov)

    reg = torch.stack([rbeg, mov, zi, best_s, best_qe, best_te, zi, zi], 0)
    out = dict(fin_planes=[p.to(I32).contiguous() for p in (us, es, qs)
                           if p is not None],
               fin_ub=ub.to(I32).contiguous(), fin_reg=reg.to(I32))
    if g.emit != "none":
        out["begs"] = torch.stack(begs_o, 0).to(I32)
    if g.emit == "codes":
        out["codes"] = torch.stack(codes_o, 0)
    elif g.emit == "planes":
        out["us"] = torch.stack(us_o, 0)
        out["es"] = torch.stack(es_o, 0) if pw >= 1 else None
        out["qs"] = torch.stack(qs_o, 0) if pw == 2 else None
        out["ubegs"] = torch.stack(ub_o, 0)
    return out


# ---------------------------------------------------------------- wrapper --

def forward_raw(g: Geometry, st: State):
    """Raw forward outputs on the device st lies on: the hand-written CUDA
    kernel for CUDA tensors (it launches or raises), the plain version for
    CPU tensors."""
    if st.qpad.is_cuda:
        from . import _cuda
        return _cuda.banded8_rows(g, st)
    return forward_plain(g, st)


def check_codes_size(g: Geometry, B: int) -> None:
    """Refuse a codes buffer past CODES_CAP_BYTES: align/pairwise.py cuts
    long targets into row chunks of T_CHUNK rows before it gets there."""
    nbytes = g.T * g.CPW * WS * B * 4
    if nbytes > CODES_CAP_BYTES:
        raise NotImplementedError(
            f"codes buffer of {nbytes} bytes (T={g.T}, W={g.W}, B={B}) exceeds "
            f"the {CODES_CAP_BYTES}-byte cap: run fewer rows per call")


def finish(g: Geometry, raw, qlen, tlen) -> ForwardResult:
    """ForwardResult from raw outputs (on any device). The global score is
    read from the final state, as the Pallas wrapper does (:1316-1326);
    mid-run chunked calls clip the corner, and their score is unused."""
    W, BW = g.W, g.BW
    fin = raw["fin_planes"]
    fin_us, fin_ub, reg = fin[0], raw["fin_ub"], raw["fin_reg"]
    rbeg = reg[0]
    if mode_type(g.mode) == MODE_GLOBAL:
        pos = (qlen - 1 - rbeg).clamp(0, BW - 1)
        x, y = pos % W, pos // W
        b = torch.arange(fin_us.shape[-1], device=fin_us.device)
        cums = torch.cumsum(fin_us, 0, dtype=I32)
        score = fin_ub[y, b] + cums[x, y, b]
        qe, te = qlen - 1, tlen - 1
    else:
        score, qe, te = reg[3], reg[4], reg[5]
    planes = RowPlanes(raw.get("us"), raw.get("es"), raw.get("qs"),
                       raw.get("ubegs"), raw.get("begs"), raw.get("codes"))
    return ForwardResult(planes, score, qe, te, fin_us, fin_ub, rbeg,
                         fin, reg)


def make_forward(T: int, W: int, mode: int, piecewise: int, gapo1: int,
                 gape1: int, gapo2: int, gape2: int, nt_max: int, nt_min: int,
                 *, scores_only: bool = False, codes: bool = False, device):
    """The batched forward for fixed geometry and costs on `device`, with
    banded8_pallas.make_forward's arguments: it emits packed codes
    (codes=True, piecewise 0/1), no per-row output (scores_only=True) or
    else the u/e/q planes.

    On a CUDA device it launches the hand-written kernel; on the CPU it
    runs the plain version. The returned function takes the operands of
    bsalign_tpu's _pack_batch and _init_state (numpy arrays or host
    tensors), then optionally init_reg and row0 to resume at global row
    row0 from an earlier call's final state, and returns a ForwardResult
    of tensors on the host. `forward.prepare` and `forward.unpack` split
    it for asynchronous launches: `outs = call(*ops)` starts the device,
    `unpack(outs, *meta)` waits for this launch's results alone."""
    emit = "none" if scores_only else ("codes" if codes else "planes")
    if emit == "codes" and piecewise == 2:
        raise ValueError("codes mode covers piecewise 0/1 only")
    g = Geometry(T, W, mode, piecewise, gapo1, gape1, gapo2, gape2, nt_max,
                 nt_min, emit)
    device = torch.device(device)

    def prepare(qpad, qlen, tseq, tlen, mtx5, rby, init_us, init_es,
                init_qs, init_ub, init_reg=None, row0=0):
        B = len(qlen)
        if emit == "codes":
            check_codes_size(g, B)
        st = state_from_numpy(qpad, qlen, tseq, tlen, mtx5, rby, init_us,
                              init_es, init_qs, init_ub, init_reg, row0, T=T,
                              device=device)
        lens = (torch.as_tensor(np.asarray(qlen, np.int32)),
                torch.as_tensor(np.asarray(tlen, np.int32)))
        return call, (st,), lens

    def call(st):
        raw = forward_raw(g, st)
        if st.qpad.is_cuda:
            from . import _cuda
            return _cuda.to_host_async(raw, st)
        return raw

    def unpack(raw, qlen, tlen):
        if device.type == "cuda":
            from . import _cuda
            raw = _cuda.wait_host(raw)
        return finish(g, raw, qlen, tlen)

    def forward(*args, init_reg=None, row0=0):
        c, ops, meta = prepare(*args, init_reg=init_reg, row0=row0)
        return unpack(c(*ops), *meta)

    forward.prepare = prepare
    forward.unpack = unpack
    return forward
