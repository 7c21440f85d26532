"""Host helpers of the 8-bit banded striped aligner that the `align` driver
calls (port of the parts of bsalign_tpu.oracle.banded8 it needs).

Layout: the reference's striped SIMD vectors are int8 arrays of shape
[W, 16] (stripe-major); natural band position p maps to [p % W, p // W]
(banded_striped_epi8_pos2idx, bsalign.h:321).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..constants import MODE_GLOBAL, SCORE_EPI8_MIN, SCORE_MIN, WORDSIZE, mode_type

WS = WORDSIZE  # 16


def c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def wrap8(x) -> np.ndarray:
    """Truncate int to int8 (C implementation-defined narrowing: wraps)."""
    return np.asarray(x).astype(np.int64).astype(np.int8)


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
    pw2 = get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth) == 2
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
    if pw2:
        st.es[:, :] = SCORE_EPI8_MIN
        st.qs[:, :] = SCORE_EPI8_MIN
    elif gapo1:
        st.es[:, :] = SCORE_EPI8_MIN
    return st


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
    M0, M1, M2, M3 = Max[0:4], Max[4:8], Max[8:12], Max[12:16]
    I0, I1, I2, I3 = Idx[0:4], Idx[4:8], Idx[8:12], Idx[12:16]
    I0 = np.where(M1 > M0, I1, I0)
    M0 = np.maximum(M0, M1)
    I1b = np.where(M3 > M2, I3, I2)
    M1b = np.maximum(M2, M3)
    I0 = np.where(M1b > M0, I1b, I0)
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
