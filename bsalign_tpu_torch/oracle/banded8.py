"""Bit-exact scalar oracle of the 8-bit banded striped pairwise aligner
(the port's own copy of bsalign_tpu.oracle.banded8, numpy only).

Replicates the semantics of the reference engine (bsalign.h:2084-4050):
difference-recurrence DP with int8 saturating arithmetic, per-stripe int32
score anchors (`ubegs`), the active F-loop (F-penetration prefix scan),
adaptive band movement with global-mode diagonal steering, and the
"backcal" score-identity traceback. The `align` driver calls its row
initialisation, scores and row maximum; `pairwise` is the CLI's debug
engine (cli.USE_DEVICE = False).

Layout: the reference's striped SIMD vectors are modeled as int8 arrays of
shape [W, 16] (stripe-major); natural band position p maps to [p % W, p // W]
(banded_striped_epi8_pos2idx, bsalign.h:321). WORDSIZE is pinned to 16 (the
reference's SSE default build) because band anchors and steering depend on it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..cigar import AlnResult
from ..constants import (MODE_GLOBAL, MODE_OVERLAP, SCORE_EPI8_MAX,
                         SCORE_EPI8_MIN, SCORE_MIN, WORDSIZE, mode_type,
                         roundup)

WS = WORDSIZE  # 16


def c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def wrap8(x) -> np.ndarray:
    """Truncate int to int8 (C implementation-defined narrowing: wraps)."""
    return np.asarray(x).astype(np.int64).astype(np.int8)


def adds8(a, b):
    """_mm_adds_epi8: saturating int8 add."""
    s = a.astype(np.int16) + np.asarray(b, dtype=np.int16)
    return np.clip(s, -128, 127).astype(np.int8)


def subs8(a, b):
    s = a.astype(np.int16) - np.asarray(b, dtype=np.int16)
    return np.clip(s, -128, 127).astype(np.int8)


def max8(a, b):
    return np.maximum(a, b)


def lane_dn(x: np.ndarray, k: int) -> np.ndarray:
    """_mm_shuffle lane shift: out[j] = x[j+k], zero-fill (and mm_srli)."""
    out = np.zeros(WS, dtype=np.int8)
    if k < WS:
        out[: WS - k] = x[k:]
    return out


def lane_up1(x: np.ndarray) -> np.ndarray:
    """_mm_slli(x, 1): out[j] = x[j-1], out[0] = 0."""
    out = np.zeros(WS, dtype=np.int8)
    out[1:] = x[:-1]
    return out


def get_piecewise(gapo1: int, gape1: int, gapo2: int, gape2: int,
                  bandwidth: int) -> int:
    """bsalign.h:2084-2092."""
    if (gapo2 < gapo1 and gape2 > gape1 and gapo2 + gape2 < gapo1 + gape1
            and c_div(gapo1 - gapo2, gape1 - gape2) < bandwidth):
        return 2
    if gapo1:
        return 1
    return 0


def set_score_matrix(mat: int, mis: int) -> np.ndarray:
    """bsalign.h:323 — 4x4 substitution matrix flattened [q*4+t]."""
    m = np.empty(16, dtype=np.int8)
    for i in range(16):
        m[i] = mis if ((i ^ (i >> 2)) & 0x3) else mat
    return m


def set_query_prof(qseq: np.ndarray, qlen: int, bandwidth: int,
                   mtx: np.ndarray) -> np.ndarray:
    """qprof[x, b, j] = score of (query pos x + j*W) vs base b, padded with
    SCORE_EPI8_MIN beyond qlen (bsalign.h:2142-2164 native variant)."""
    W = bandwidth // WS
    xlen = max(qlen, bandwidth)
    # per-(x, j) cell reads query position x + j*W; everything positional is
    # 1-D over [0, xlen + (WS-1)*W], gathered into the striped layout once
    n1 = xlen + 1 + (WS - 1) * W
    pos = np.arange(n1)
    valid1 = pos < qlen
    qv1 = np.where(valid1, qseq[np.minimum(pos, qlen - 1)], 0)
    qv1 = np.minimum(qv1.astype(np.int64), 4)
    # row 4: N scores as SCORE_EPI8_MIN (the reference reads out-of-bounds
    # matrix memory here, main.c cat path; we define it instead)
    m4 = np.full((5, 4), SCORE_EPI8_MIN, np.int8)
    m4[:4] = mtx.reshape(4, 4)  # [qbase, tbase]
    vals1 = np.where(valid1[:, None], m4[qv1], SCORE_EPI8_MIN)  # [pos, b]
    xs = np.arange(xlen + 1)[:, None] + np.arange(WS)[None, :] * W
    return np.ascontiguousarray(vals1[xs].transpose(0, 2, 1))


class RowState:
    """One DP row: striped u/e/q planes + absolute stripe anchors."""

    __slots__ = ("us", "es", "qs", "ubegs")

    def __init__(self, W: int, piecewise: int):
        self.us = np.zeros((W, WS), dtype=np.int8)
        self.es = np.zeros((W, WS), dtype=np.int8) if piecewise else None
        self.qs = np.zeros((W, WS), dtype=np.int8) if piecewise == 2 else None
        self.ubegs = np.zeros(WS + 1, dtype=np.int64)


def row_init(mode: int, bandwidth: int, nt_max: int, nt_min: int,
             gapo1: int, gape1: int, gapo2: int, gape2: int) -> RowState:
    """bsalign.h:2094-2140."""
    W = bandwidth // WS
    pw2 = (gapo2 < gapo1 and gape2 > gape1 and gapo2 + gape2 < gapo1 + gape1
           and c_div(gapo1 - gapo2, gape1 - gape2) < bandwidth)
    piecewise = 2 if pw2 else (1 if gapo1 else 0)
    st = RowState(W, piecewise)
    if mode_type(mode) in (MODE_GLOBAL, 2):  # GLOBAL or EXTEND
        if pw2:
            xp = c_div(gapo2 - gapo1, gape1 - gape2)
            st.us[:, :] = gape2
            st.ubegs[:WS] = gape2 * W
            st.us[0, 0] = wrap8(gapo1 + gape1 + nt_min - nt_max)
            st.ubegs[0] += int(st.us[0, 0]) - gape2
            for k in range(1, xp):
                st.us[k % W, k // W] = gape1
                st.ubegs[k // W] += gape1 - gape2
        else:
            st.us[:, :] = gape1
            st.us[0, 0] = wrap8(gapo1 + gape1 + nt_min - nt_max)
            st.ubegs[:WS] = gape1 * W
            st.ubegs[0] += int(st.us[0, 0]) - gape1
        s = nt_max - nt_min
        for k in range(WS):
            t = int(st.ubegs[k])
            st.ubegs[k] = s
            s += t
        st.ubegs[WS] = s
    else:
        st.us[:, :] = 0
        st.ubegs[:] = 0
    if pw2:
        st.es[:, :] = SCORE_EPI8_MIN
        st.qs[:, :] = SCORE_EPI8_MIN
    elif gapo1:
        st.es[:, :] = SCORE_EPI8_MIN
    return st


def row_movx(prev: RowState, W: int, movx: int, piecewise: int, nt_max: int,
             nt_min: int, gapo1: int, gape1: int, gapo2: int,
             gape2: int) -> RowState:
    """Shift the band left by movx natural positions, re-anchor ubegs and
    initialize the overhang as mimicked insertions (bsalign.h:2244-2392)."""
    cur = RowState(W, piecewise)
    B = W * WS
    if movx >= B:
        # all state reset; anchors to SCORE_MIN (bsalign.h:2253-2259)
        cur.ubegs[:] = SCORE_MIN
        if piecewise:
            cur.es[:, :] = 0
        if piecewise == 2:
            cur.qs[:, :] = 0
        return cur
    if movx == 0:
        cur.us[:] = prev.us
        if piecewise:
            cur.es[:] = prev.es
        if piecewise == 2:
            cur.qs[:] = prev.qs
        cur.ubegs[:] = prev.ubegs
        return cur
    cyc = movx // W
    mov = movx % W
    div = W - mov
    for i in range(div):
        cur.us[i] = lane_dn(prev.us[i + mov], cyc)
    if piecewise:
        for i in range(div):
            cur.es[i] = lane_dn(prev.es[i + mov], cyc)
    if piecewise == 2:
        for i in range(div):
            cur.qs[i] = lane_dn(prev.qs[i + mov], cyc)
    if mov:
        ubt = prev.ubegs[:WS].copy()
        for i in range(div, W):
            ubt += prev.us[i - div].astype(np.int64)
            cur.us[i] = lane_dn(prev.us[i - div], cyc + 1)
        if piecewise:
            for i in range(div, W):
                cur.es[i] = lane_dn(prev.es[i - div], cyc + 1)
        if piecewise == 2:
            for i in range(div, W):
                cur.qs[i] = lane_dn(prev.qs[i - div], cyc + 1)
        cur.ubegs[: WS - cyc] = ubt[cyc:WS]
    else:
        cur.ubegs[: WS - cyc] = prev.ubegs[cyc:WS]
    cur.ubegs[WS - cyc:] = prev.ubegs[WS]
    # mimic insertions on the overhang (bsalign.h:2357-2390)
    d = c_div(gapo1 - gapo2, gape2 - gape1) if piecewise == 2 else B + 1
    i0 = B - movx
    a = i0 % W
    a2 = (i0 + d) % W
    b = i0 // W
    b2 = (i0 + d) // W
    if piecewise == 2:
        c = min(nt_min, gapo2 + gape2) - 1 - nt_max + (gapo2 + gape2)
    else:
        c = min(nt_min, gapo1 + gape1) - 1 - nt_max + (gapo1 + gape1)
    cur.us[i0 % W, i0 // W] = wrap8(c)
    a += 1
    broke = False
    while b < WS and b <= b2:
        if b == b2:
            c += (a2 - a) * gape1
            while a < a2:
                cur.us[a, b] = gape1
                a += 1
            a = a2
            if a2 < W:
                broke = True
                break
        c += (W - a) * gape1
        while a < W:
            cur.us[a, b] = gape1
            a += 1
        cur.ubegs[b + 1] += c
        a = 0
        b += 1
    _ = broke
    while b < WS:
        c += (W - a) * gape2
        while a < W:
            cur.us[a, b] = gape2
            a += 1
        cur.ubegs[b + 1] += c
        a = 0
        b += 1
    return cur


def _fpenetration(f: np.ndarray, ubegs0: np.ndarray, gape: int,
                  W: int) -> np.ndarray:
    """Active F-loop prefix fix-up across stripe blocks (bsalign.h:2639-2652).
    The fs[] store is a b1i array in C: out-of-range ints wrap."""
    fs = lane_up1(f).copy()
    fs[0] = SCORE_EPI8_MIN
    t = W * gape
    s = t + int(fs[0]) - int(ubegs0[1] - ubegs0[0])
    for i in range(1, WS):
        if int(fs[i]) < s:
            fs[i] = wrap8(s)
        s = t + int(fs[i]) - int(ubegs0[i + 1] - ubegs0[i])
    return fs


def _row_cal_tail(h: np.ndarray, u: np.ndarray, v: np.ndarray,
                  cur: RowState, prev_ubegs: np.ndarray) -> int:
    """bsalign.h:2618-2636."""
    v2 = subs8(h, u)
    for i in range(1, WS + 1):
        cur.ubegs[i] = prev_ubegs[i] + int(v2[i - 1])
    v3 = lane_up1(v2)
    cur.us[0] = subs8(cur.us[0], v3)
    cur.ubegs[0] = prev_ubegs[0] + int(cur.us[0][0])
    cur.us[0][0] = 0
    return int(cur.ubegs[0])


def _h0_init(rh: int, ub0: int, qp0: int, t: int) -> int:
    h0 = (rh - ub0) + qp0
    if h0 >= t:
        if h0 > SCORE_EPI8_MAX:
            h0 = SCORE_EPI8_MAX
    else:
        h0 = SCORE_EPI8_MIN
    return h0


def row_cal(rbeg: int, base: int, prev: RowState, cur: RowState,
            qprof: np.ndarray, gapo1: int, gape1: int, gapo2: int,
            gape2: int, W: int, rh: int, piecewise: int) -> int:
    """One DP row update (piece0/1/2_row_cal, bsalign.h:2727-3185)."""
    if piecewise == 0:
        return _piece0_row_cal(rbeg, base, prev, cur, qprof, gape1, W, rh)
    if piecewise == 1:
        return _piece1_row_cal(rbeg, base, prev, cur, qprof, gapo1, gape1, W, rh)
    return _piece2_row_cal(rbeg, base, prev, cur, qprof, gapo1, gape1, gapo2,
                           gape2, W, rh)


def _piece0_row_cal(rbeg, base, prev, cur, qprof, gape1, W, rh):
    GapE = np.int8(gape1)
    f = np.full(WS, SCORE_EPI8_MIN, dtype=np.int8)
    h0 = _h0_init(rh, int(prev.ubegs[0]), int(qprof[rbeg, base, 0]),
                  int(prev.us[0, 0]) + gape1)
    h = qprof[rbeg, base].copy()
    h[0] = wrap8(h0)
    for i in range(W):
        u = prev.us[i]
        e = adds8(u, GapE)
        h = max8(e, h)
        h = max8(f, h)
        f = adds8(h, GapE)
        f = subs8(f, u)
        h = qprof[rbeg + i + 1, base]
    f = _fpenetration(f, prev.ubegs, gape1, W)
    v = np.zeros(WS, dtype=np.int8)
    z = qprof[rbeg, base].copy()
    z[0] = wrap8(h0)
    u = np.zeros(WS, dtype=np.int8)
    for i in range(W):
        u = prev.us[i]
        e = adds8(u, GapE)
        h = max8(e, z)
        h = max8(f, h)
        cur.us[i] = subs8(h, v)
        v = subs8(h, u)
        f = adds8(h, GapE)
        f = subs8(f, u)
        z = qprof[rbeg + i + 1, base]
    return _row_cal_tail(h, u, v, cur, prev.ubegs)


def _piece1_row_cal(rbeg, base, prev, cur, qprof, gapo1, gape1, W, rh):
    GapOE = np.int8(gapo1 + gape1)
    GapE = np.int8(gape1)
    f = np.full(WS, SCORE_EPI8_MIN, dtype=np.int8)
    h0 = _h0_init(rh, int(prev.ubegs[0]), int(qprof[rbeg, base, 0]),
                  int(prev.us[0, 0]) + int(prev.es[0, 0]))
    h = qprof[rbeg, base].copy()
    h[0] = wrap8(h0)
    for i in range(W):
        u = prev.us[i]
        e = adds8(prev.es[i], u)
        h = max8(e, h)
        h = max8(f, h)
        f = adds8(f, GapE)
        h = adds8(h, GapOE)
        f = max8(f, h)
        f = subs8(f, u)
        h = qprof[rbeg + i + 1, base]
    f = _fpenetration(f, prev.ubegs, gape1, W)
    u = np.zeros(WS, dtype=np.int8)
    v = np.zeros(WS, dtype=np.int8)
    z = qprof[rbeg, base].copy()
    z[0] = wrap8(h0)
    for i in range(W):
        u = prev.us[i]
        e = adds8(prev.es[i], u)
        h = max8(e, z)
        h = max8(f, h)
        cur.us[i] = subs8(h, v)
        v = subs8(h, u)
        e = adds8(e, GapE)
        e = subs8(e, h)
        e = max8(e, np.full(WS, GapOE, dtype=np.int8))
        cur.es[i] = e
        f = adds8(f, GapE)
        h = adds8(h, GapOE)
        f = max8(f, h)
        f = subs8(f, u)
        z = qprof[rbeg + i + 1, base]
    h = subs8(h, GapOE)
    return _row_cal_tail(h, u, v, cur, prev.ubegs)


def _piece2_row_cal(rbeg, base, prev, cur, qprof, gapo1, gape1, gapo2, gape2,
                    W, rh):
    GapOE = np.int8(gapo1 + gape1)
    GapE = np.int8(gape1)
    GapQP = np.int8(gapo2 + gape2)
    GapP = np.int8(gape2)
    GapOQ = np.int8(np.clip(int(GapOE) - int(GapQP), -128, 127))
    f = np.full(WS, SCORE_EPI8_MIN, dtype=np.int8)
    g = np.full(WS, SCORE_EPI8_MIN, dtype=np.int8)
    h0 = _h0_init(rh, int(prev.ubegs[0]), int(qprof[rbeg, base, 0]),
                  int(prev.us[0, 0]) + max(int(prev.es[0, 0]), int(prev.qs[0, 0])))
    h = qprof[rbeg, base].copy()
    h[0] = wrap8(h0)
    for i in range(W):
        u = prev.us[i]
        e = adds8(prev.es[i], u)
        q = adds8(prev.qs[i], u)
        h = max8(e, h)
        h = max8(q, h)
        h = max8(f, h)
        h = max8(g, h)
        f = adds8(f, GapE)
        h = adds8(h, GapOE)
        f = max8(f, h)
        f = subs8(f, u)
        g = adds8(g, GapP)
        h = subs8(h, GapOQ)
        g = max8(g, h)
        g = subs8(g, u)
        h = qprof[rbeg + i + 1, base]
    f = _fpenetration(f, prev.ubegs, gape1, W)
    g = _fpenetration(g, prev.ubegs, gape2, W)
    v = np.zeros(WS, dtype=np.int8)
    z = qprof[rbeg, base].copy()
    z[0] = wrap8(h0)
    u = np.zeros(WS, dtype=np.int8)
    for i in range(W):
        u = prev.us[i]
        e = adds8(prev.es[i], u)
        h = max8(e, z)
        q = adds8(prev.qs[i], u)
        h = max8(q, h)
        h = max8(f, h)
        h = max8(g, h)
        cur.us[i] = subs8(h, v)
        v = subs8(h, u)
        e = adds8(e, GapE)
        e = subs8(e, h)
        e = max8(e, np.full(WS, GapOE, dtype=np.int8))
        cur.es[i] = e
        q = adds8(q, GapP)
        q = subs8(q, h)
        q = max8(q, np.full(WS, GapQP, dtype=np.int8))
        cur.qs[i] = q
        f = adds8(f, GapE)
        h = adds8(h, GapOE)
        f = max8(f, h)
        f = subs8(f, u)
        g = adds8(g, GapP)
        h = subs8(h, GapOQ)
        g = max8(g, h)
        g = subs8(g, u)
        z = qprof[rbeg + i + 1, base]
    h = subs8(h, GapQP)
    return _row_cal_tail(h, u, v, cur, prev.ubegs)


def getscore(st: RowState, W: int, pos: int) -> int:
    """Absolute H score at natural band position pos (bsalign.h:3187-3197)."""
    x = pos % W
    y = pos // W
    s = int(st.ubegs[y])
    for i in range(x + 1):
        s += int(st.us[i, y])
    return s


def row_max(st: RowState, W: int) -> Tuple[int, int]:
    """Vectorized row max + position with the reference's exact tie-breaking
    tree (bsalign.h:3213-3329). Returns (natural_pos, max_score)."""
    STEP = 32
    Scr = st.ubegs[:WS].astype(np.int64).copy()
    Max = np.full(WS, SCORE_MIN, dtype=np.int64)
    Idx = np.arange(WS, dtype=np.int64)
    Pos = np.arange(WS, dtype=np.int64)
    i = 0
    while i < W:
        x = min(i + STEP, W) - i
        scr = np.zeros(WS, dtype=np.int64)
        mx = np.full(WS, -0x7FFF, dtype=np.int64)
        for j in range(x):
            scr += st.us[i + j].astype(np.int64)
            mx = np.maximum(mx, scr)
        h = Scr + mx
        upd = h > Max
        Idx = np.where(upd, Pos, Idx)
        Max = np.maximum(Max, h)
        Scr += scr
        Pos = Pos + (1 << 8)
        i += x
    # cross-lane reduction tree: groups of 4 epi32 lanes
    M0, M1, M2, M3 = Max[0:4].copy(), Max[4:8].copy(), Max[8:12].copy(), Max[12:16].copy()
    I0, I1, I2, I3 = Idx[0:4].copy(), Idx[4:8].copy(), Idx[8:12].copy(), Idx[12:16].copy()
    c = M1 > M0
    I0 = np.where(c, I1, I0)
    M0 = np.maximum(M0, M1)
    c = M3 > M2
    I1b = np.where(c, I3, I2)
    M1b = np.maximum(M2, M3)
    c = M1b > M0
    I0 = np.where(c, I1b, I0)
    M0 = np.maximum(M0, M1b)
    max_score = int(M0[0])
    x = 0
    for k in range(1, 4):
        if int(M0[k]) > max_score:
            max_score = int(M0[k])
            x = k
    enc = int(I0[x])
    lane = enc & 0xFF
    chunk = enc >> 8
    y = min((chunk + 1) * STEP, W)
    jb = chunk * STEP
    j_best = jb
    umax = SCORE_MIN
    uscr = 0
    for j in range(jb, y):
        uscr += int(st.us[j, lane])
        if uscr > umax:
            j_best = j
            umax = uscr
    return lane * W + j_best, max_score


def band_mov(st: RowState, W: int, tidx: int, qoff: int, qlen: int) -> int:
    """Adaptive band steering decision (bsalign.h:3331-3349)."""
    if tidx <= W * WS // 4:
        return 0
    if qoff + W * WS >= qlen:
        return 0
    noisy = 0
    for i in range(1, WS + 1):
        noisy += abs(int(st.ubegs[i]) - int(st.ubegs[i - 1]))
    noisy = max(2 * WS // 2, noisy // WS // W * WS // 2)
    if int(st.ubegs[0]) + noisy < int(st.ubegs[WS]):
        return 2
    if int(st.ubegs[0]) > int(st.ubegs[WS]) + noisy:
        return 0
    return 1


class _CigAcc:
    """back-to-front cigar accumulator mirroring _push_cigar_bsalign."""

    def __init__(self):
        self.cg = 0
        self.out: List[int] = []

    def push(self, op: int, sz: int) -> None:
        if op == (self.cg & 0xF):
            self.cg += sz << 4
        else:
            if self.cg:
                self.out.append(self.cg)
            self.cg = (sz << 4) | op

    def finish(self) -> List[int]:
        if self.cg:
            self.out.append(self.cg)
            self.cg = 0
        return self.out[::-1]


def _backcal_cell(x: int, qbase: int, tbase: int, Hs1_minus_Hs0: int, u: int,
                  e: int, q: int, W: int, mtx: np.ndarray, piecewise: int,
                  prior_match: int) -> int:
    """Score-identity cell rule (bsalign.h:3667-3702)."""
    s = int(mtx[qbase * 4 + tbase])
    h = Hs1_minus_Hs0
    if x > W * WS:
        return 1  # BT_I
    if x == W * WS:
        return 0 if h == s else 1
    if prior_match:
        if h == s:
            return 0
        if h == u + e:
            return 2  # BT_D
        if piecewise == 2 and h == u + q:
            return 4  # BT2_D2
        return 1
    if h == u + e:
        return 2
    if piecewise == 2 and h == u + q:
        return 4
    if h == s:
        return 0
    return 1


def backcal(qseq: np.ndarray, tseq: np.ndarray, init_row: RowState,
            rows: List[RowState], begs: List[int], mode: int, bandwidth: int,
            mtx: np.ndarray, gapo1: int, gape1: int, gapo2: int, gape2: int,
            rs: AlnResult) -> List[int]:
    """Traceback by score identities over stored rows (bsalign.h:3704-3852).

    rows[i] is the DP row for target base i; begs[i] its band offset. The C
    arena keeps the init row at index -1 (bsalign.h:3897/3922); here it is
    passed explicitly as init_row (band offset 0).
    """
    piecewise = get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth)
    W = bandwidth // WS

    def row_at(i: int) -> RowState:
        return rows[i] if i >= 0 else init_row

    def beg(i: int) -> int:
        return begs[i] if i >= 0 else 0

    def score_at(row: int, col: int) -> int:
        return getscore(row_at(row), W, col - beg(row))

    rs.qb = rs.qe
    rs.qe += 1
    rs.tb = rs.te
    rs.te += 1
    rs.mat = rs.mis = rs.ins = rs.dele = rs.aln = 0
    acc = _CigAcc()
    Hs0 = 0
    Hs1 = score_at(rs.tb, rs.qb)
    Hs2 = 0
    prior_match = 0
    while True:
        if (Hs2 & 0xF) == 2:  # extending a D run via E identity
            Hs0 = score_at(rs.tb, rs.qb)
            t = gapo1 + (Hs2 >> 4) * gape1
            if Hs0 + t == Hs1:
                acc.push(2, Hs2 >> 4)
                rs.dele += Hs2 >> 4
                rs.aln += Hs2 >> 4
                Hs1 = Hs0
                Hs2 = 0
            else:
                Hs2 += 1 << 4
                rs.tb -= 1
                continue
        elif (Hs2 & 0xF) == 4:  # D2 run via Q identity
            Hs0 = score_at(rs.tb, rs.qb)
            t = gapo2 + (Hs2 >> 4) * gape2
            if Hs0 + t == Hs1:
                acc.push(2, Hs2 >> 4)
                rs.dele += Hs2 >> 4
                rs.aln += Hs2 >> 4
                Hs1 = Hs0
                Hs2 = 0
            else:
                Hs2 += 1 << 4
                rs.tb -= 1
                continue
        if rs.qb < 0 or rs.tb < 0:
            break
        if rs.qb == beg(rs.tb - 1):
            if rs.qb:
                Hs0 = int(row_at(rs.tb - 1).ubegs[0])
                prior_match = 0
            else:
                if mode_type(mode) == MODE_OVERLAP or rs.tb == 0:
                    Hs0 = 0
                elif piecewise < 2:
                    Hs0 = gapo1 + gape1 * rs.tb
                else:
                    Hs0 = max(gapo1 + gape1 * rs.tb, gapo2 + gape2 * rs.tb)
        else:
            Hs0 = score_at(rs.tb - 1, rs.qb - 1)
        x = rs.qb - beg(rs.tb - 1)
        prow = row_at(rs.tb - 1)
        if 0 <= x < W * WS:
            si, sj = x % W, x // W
            uval = int(prow.us[si, sj])
            eval_ = int(prow.es[si, sj]) if prow.es is not None else gapo1 + gape1
            qval = int(prow.qs[si, sj]) if prow.qs is not None else 0
        else:
            uval, eval_, qval = 0, gapo1 + gape1, 0
        bt = _backcal_cell(x, int(qseq[rs.qb]), int(tseq[rs.tb]), Hs1 - Hs0,
                           uval, eval_, qval, W, mtx, piecewise, prior_match)
        prior_match = 1
        if bt == 0:  # M
            if qseq[rs.qb] == tseq[rs.tb]:
                rs.mat += 1
            else:
                rs.mis += 1
            rs.qb -= 1
            rs.tb -= 1
            rs.aln += 1
            acc.push(0, 1)
            Hs1 = Hs0
        elif bt == 1:  # I
            if rs.qb <= 0:
                acc.push(1, 1)
                Hs1 = Hs0
                rs.qb -= 1
                rs.ins += 1
                rs.aln += 1
            else:
                sz = 1
                while sz + beg(rs.tb) <= rs.qb:
                    if piecewise == 2:
                        t = max(gapo1 + sz * gape1, gapo2 + sz * gape2)
                    else:
                        t = gapo1 + sz * gape1
                    Hs0 = score_at(rs.tb, rs.qb - sz)
                    if Hs0 + t == Hs1:
                        acc.push(1, sz)
                        Hs1 = Hs0
                        rs.qb -= sz
                        rs.ins += sz
                        rs.aln += sz
                        break
                    sz += 1
        else:  # start a D / D2 run
            Hs2 = (1 << 4) | bt
            rs.tb -= 1
            continue
    if mode_type(mode) == MODE_OVERLAP:
        pass
    else:
        if rs.qb >= 0:
            op, sz = 1, rs.qb + 1
            rs.ins += sz
            rs.qb = -1
        elif rs.tb >= 0:
            op, sz = 2, rs.tb + 1
            rs.dele += sz
            rs.tb = -1
        else:
            op = sz = 0
        rs.aln += sz
        if sz:
            acc.push(op, sz)
    cigars = acc.finish()
    rs.qb += 1
    rs.tb += 1
    return cigars


def pairwise(qseq: np.ndarray, tseq: np.ndarray, mode: int, bandwidth: int,
             mtx: np.ndarray, gapo1: int, gape1: int, gapo2: int,
             gape2: int, return_rows: bool = False):
    """Full pairwise driver (bsalign.h:3854-4050)."""
    qlen, tlen = len(qseq), len(tseq)
    if bandwidth == 0:
        bandwidth = qlen
    bandwidth = roundup(bandwidth, WS)
    W = bandwidth // WS
    piecewise = get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth)
    smax = int(mtx.max())
    smin = int(mtx.min())
    U32 = (1 << 32) - 1
    rs = AlnResult(score=SCORE_MIN)
    init = row_init(mode, bandwidth, smax, smin, gapo1, gape1, gapo2, gape2)
    rows: List[RowState] = []
    begs: List[int] = []
    prev = init
    rbeg = 0
    mov = 0
    for i in range(tlen):
        tbase = int(tseq[i])
        if mov and rbeg + bandwidth < qlen:
            mov = min(mov, max(0, qlen - (rbeg + bandwidth)))
            rbeg += mov
            rh = getscore(prev, W, mov - 1)
        else:
            mov = 0
            if rbeg:
                rh = SCORE_MIN
            else:
                if mode_type(mode) == MODE_OVERLAP or i == 0:
                    rh = 0
                elif piecewise < 2:
                    rh = gapo1 + gape1 * i
                else:
                    rh = max(gapo1 + gape1 * i, gapo2 + gape2 * i)
        shifted = row_movx(prev, W, mov, piecewise, smax, smin, gapo1, gape1,
                           gapo2, gape2)
        cur = RowState(W, piecewise)
        if i == 0:
            qprof = set_query_prof(qseq, qlen, bandwidth, mtx)
        row_cal(rbeg, tbase, shifted, cur, qprof, gapo1, gape1, gapo2, gape2,
                W, rh, piecewise)
        rows.append(cur)
        rbx = band_mov(cur, W, i, rbeg, qlen)
        if mode_type(mode) == MODE_GLOBAL:
            rbz = 2 * max(tlen // qlen, 1)
            rby = int((1.0 * i / tlen) * qlen)
            if rbeg + rbz * (tlen - i - 1) + bandwidth <= ((qlen + rbz - 1) & U32):
                mov = (1 + (((qlen - (rbeg + bandwidth)) & U32)
                            // max(1, tlen - i - 1))) & U32
            elif rbeg < rby - bandwidth:
                mov = rbx + 1
            elif rbeg > rby:
                mov = max(0, rbx - 1)
            else:
                mov = rbx
        else:
            mov = rbx
        begs.append(rbeg)
        if mode_type(mode) != MODE_GLOBAL:
            if rbeg + bandwidth >= qlen:
                score = getscore(cur, W, qlen - 1 - rbeg)
                if score > rs.score:
                    rs.score = score
                    rs.qe = qlen - 1
                    rs.te = i
        prev = cur
    if mode_type(mode) == MODE_GLOBAL:
        rs.score = getscore(prev, W, qlen - 1 - rbeg)
        rs.qe = qlen - 1
        rs.te = tlen - 1
    else:
        rmax, max_score = row_max(prev, W)
        if max_score > rs.score:
            rs.score = max_score
            rs.qe = rbeg + rmax
            rs.te = tlen - 1
    cigars = backcal(qseq, tseq, init, rows, begs, mode, bandwidth, mtx,
                     gapo1, gape1, gapo2, gape2, rs)
    if return_rows:
        return rs, cigars, init, rows, begs
    return rs, cigars
