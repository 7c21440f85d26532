"""Plain reference of bsalign's banded pairwise alignment (`align`), in NumPy.

bsalign (bsalign.h:2084-4050) fills a band of BW query columns on each
target row with a 2-piece affine DP, held as striped int8 differences over
int32 anchors. The band moves along the query by a rule that reads the
row's scores at the stripes' lane boundaries, and a traceback by score
identities ("backcal") picks one of the best paths. This module computes
the same alignment in natural column order, one band row as one vector, in
exact 64-bit integers, and walks it with backcal's rules:

- inside the band, H = max(diag + s, E, Q, F, G) with E/F the first gap
  piece (open go1, extend ge1) and Q/G the second (go2, ge2); F and G come
  from a running maximum along the row, columns past the query score as
  minus infinity (bsalign pads its query profile with int8's minimum);
- the row before the first (bsalign's row_init) and the column before the
  first per mode; E and Q of the first row are minus infinity there;
- band moves (band_mov, and global mode's diagonal steering), the columns
  a move uncovers carrying bsalign's mimicked insertion scores;
- overlap and extend scores from the last column and the last row's
  maximum, with bsalign's tie order among equal maxima;
- backcal's cell rules, read through the values bsalign stores: u the
  row's difference to the column before (0 at the band's first column),
  e and q the next row's E and Q less this row's H.

It imports nothing of the program under test. `align` takes the codes
0-3 of both sequences; `gap_first=True` breaks the traceback's ties
between a match and a gap toward the gap (the control: same scores, other
CIGARs).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

WS = 16                    # bsalign's striped word: 16 lanes of int8
NEG = -(1 << 40)           # minus infinity
SCORE_MIN = -(1 << 28)     # bsalign's "no score yet"
U32 = (1 << 32) - 1
MODES = {"global": 0, "overlap": 1, "extend": 2}
FIELDS = ("score", "qb", "qe", "tb", "te", "mat", "mis", "ins", "dele",
          "aln")


def c_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def wrap8(x: int) -> int:
    return (int(x) + 128) % 256 - 128


def roundup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def score_matrix(match: int, mismatch: int) -> np.ndarray:
    """4 x 4 substitution scores, [query base, target base]."""
    m = np.full((4, 4), mismatch, np.int64)
    np.fill_diagonal(m, match)
    return m


def piecewise(go1: int, ge1: int, go2: int, ge2: int, band: int) -> int:
    """2 when the second gap piece ever costs less within the band, else 1
    (bsalign.h:2084-2092)."""
    if (go2 < go1 and ge2 > ge1 and go2 + ge2 < go1 + ge1
            and c_div(go1 - go2, ge1 - ge2) < band):
        return 2
    return 1 if go1 else 0


def band_of(qlen: int, W: int) -> int:
    """The band of one pair: -W, or at -W 0 the query rounded up to 128
    (bsalign's main.c), in words of 16."""
    return roundup(W if W > 0 else roundup(qlen, 128), WS)


class Rows:
    """The forward's rows: H, the next row's E and Q (En, Qn), band starts."""

    def __init__(self, tlen: int, BW: int):
        self.H = np.empty((tlen, BW), np.int64)
        self.En = np.empty((tlen, BW), np.int64)
        self.Qn = np.empty((tlen, BW), np.int64)
        self.begs = np.zeros(tlen, np.int64)


def _init_row(mode: int, BW: int, pw: int, mtx, go1, ge1, go2, ge2):
    """H of the row before the first and its stored first difference."""
    if mode == MODES["overlap"]:
        return np.zeros(BW, np.int64), 0
    d = np.full(BW, ge2 if pw == 2 else ge1, np.int64)
    if pw == 2:
        d[1:c_div(go2 - go1, ge1 - ge2)] = ge1
    d[0] = go1 + ge1
    return np.cumsum(d), wrap8(go1 + ge1 + int(mtx.min()) - int(mtx.max()))


def _boundary(mode: int, i: int, pw: int, go1, ge1, go2, ge2) -> int:
    """H of the column before the first on row i - 1."""
    if mode == MODES["overlap"] or i == 0:
        return 0
    if pw < 2:
        return go1 + ge1 * i
    return max(go1 + ge1 * i, go2 + ge2 * i)


def _gap_run(H0: np.ndarray, go: int, ge: int, p: np.ndarray) -> np.ndarray:
    """max over k < p of H0[k] + go + ge * (p - k): a gap along the row."""
    run = np.maximum.accumulate(H0 - ge * p)
    out = np.full(len(H0), NEG, np.int64)
    out[1:] = run[:-1] + go + ge * p[1:]
    return out


def _band_mov(ub: List[int], W: int, i: int, rbeg: int, qlen: int) -> int:
    """bsalign.h:3331-3349."""
    if i <= W * WS // 4 or rbeg + W * WS >= qlen:
        return 0
    noisy = sum(abs(ub[k] - ub[k - 1]) for k in range(1, WS + 1))
    noisy = max(2 * WS // 2, noisy // WS // W * WS // 2)
    if ub[0] + noisy < ub[WS]:
        return 2
    if ub[0] > ub[WS] + noisy:
        return 0
    return 1


def _row_max(H: np.ndarray, W: int) -> Tuple[int, int]:
    """(position, score) of the row's maximum, ties broken as bsalign's
    vector tree does (bsalign.h:3213-3329): the lane 4g + k with the
    smallest k, then the smallest g, then the first position in it."""
    m = int(H.max())
    at = np.nonzero(H == m)[0]
    lanes = at // W
    key = (lanes % 4) * 4 + lanes // 4
    lane = int(lanes[np.argmin(key)])
    return int(at[lanes == lane].min()), m


def forward(q, t, mode: int, BW: int, mtx, go1, ge1, go2, ge2, pw):
    """(rows, init row, its first stored difference, AlnResult fields so
    far) of bsalign's banded forward."""
    qlen, tlen = len(q), len(t)
    W = BW // WS
    p = np.arange(BW, dtype=np.int64)
    S = np.full((4, qlen + BW + 1), NEG, np.int64)
    S[:, :qlen] = mtx[q].T
    Hinit, us00 = _init_row(mode, BW, pw, mtx, go1, ge1, go2, ge2)
    rows = Rows(tlen, BW)
    H, En, Qn = Hinit, np.full(BW, NEG, np.int64), np.full(BW, NEG, np.int64)
    # the mimicked insertions on columns a band move uncovers
    # (bsalign.h:2357-2390): the first one step of c0 from the row's last
    # score, then ge1 on up to the crossover d, then ge2
    go_, ge_ = (go2, ge2) if pw == 2 else (go1, ge1)
    c0 = min(int(mtx.min()), go_ + ge_) - 1 - int(mtx.max()) + go_ + ge_
    d = c_div(go1 - go2, ge2 - ge1) if pw == 2 else BW + 1
    if not -128 <= c0 < 128:
        raise ValueError("gap costs outside what bsalign's int8 rows hold")
    res = {"score": SCORE_MIN, "qe": 0, "te": 0}
    rbeg = mov = 0
    for i in range(tlen):
        if mov and rbeg + BW < qlen:
            mov = min(mov, max(0, qlen - (rbeg + BW)))
            rbeg += mov
            rh = int(H[mov - 1])
        else:
            mov = 0
            rh = NEG if rbeg else _boundary(mode, i, pw, go1, ge1, go2, ge2)
        if mov >= BW:
            raise NotImplementedError("a band move past the whole band")
        Hs = np.empty(BW, np.int64)
        Hs[:BW - mov] = H[mov:]
        Es = np.empty(BW, np.int64)
        Es[:BW - mov] = En[mov:]
        Qs = np.empty(BW, np.int64)
        Qs[:BW - mov] = Qn[mov:]
        if mov:
            k = np.arange(mov, dtype=np.int64)
            Hs[BW - mov:] = (H[BW - 1] + c0 + ge1 * np.minimum(k, d - 1)
                             + ge2 * np.maximum(0, k - d + 1))
            Es[BW - mov:] = Hs[BW - mov:]
            Qs[BW - mov:] = Hs[BW - mov:]
        srow = S[int(t[i]), rbeg:rbeg + BW]
        diag = np.empty(BW, np.int64)
        diag[0] = max(rh + srow[0], NEG)
        diag[1:] = Hs[:-1] + srow[1:]
        H0 = np.maximum(diag, Es)
        if pw == 2:
            H0 = np.maximum(H0, Qs)
        H = np.maximum(H0, _gap_run(H0, go1, ge1, p))
        if pw == 2:
            H = np.maximum(H, _gap_run(H0, go2, ge2, p))
        H = np.maximum(H, NEG)
        En = np.maximum(Es + ge1, H + go1 + ge1)
        Qn = np.maximum(Qs + ge2, H + go2 + ge2) if pw == 2 else Qs
        rows.H[i], rows.En[i], rows.Qn[i], rows.begs[i] = H, En, Qn, rbeg
        ub = [int(H[0])] + [int(x) for x in H[W - 1::W]]
        rbx = _band_mov(ub, W, i, rbeg, qlen)
        if mode == MODES["global"]:
            rbz = 2 * max(tlen // qlen, 1)
            rby = int((1.0 * i / tlen) * qlen)
            if rbeg + rbz * (tlen - i - 1) + BW <= ((qlen + rbz - 1) & U32):
                mov = (1 + (((qlen - (rbeg + BW)) & U32)
                            // max(1, tlen - i - 1))) & U32
            elif rbeg < rby - BW:
                mov = rbx + 1
            elif rbeg > rby:
                mov = max(0, rbx - 1)
            else:
                mov = rbx
        else:
            mov = rbx
            if rbeg + BW >= qlen and int(H[qlen - 1 - rbeg]) > res["score"]:
                res = {"score": int(H[qlen - 1 - rbeg]), "qe": qlen - 1,
                       "te": i}
    if mode == MODES["global"]:
        res = {"score": int(H[qlen - 1 - rbeg]), "qe": qlen - 1,
               "te": tlen - 1}
    else:
        pos, m = _row_max(H, W)
        if m > res["score"]:
            res = {"score": m, "qe": rbeg + pos, "te": tlen - 1}
    return rows, Hinit, us00, res


def backcal(q, t, mode: int, BW: int, mtx, go1, ge1, go2, ge2, pw, rows,
            Hinit, us00, res, gap_first: bool = False):
    """(fields, packed CIGAR) by bsalign's backcal (bsalign.h:3704-3852)
    over the forward's rows."""
    H, En, Qn, begs = rows.H, rows.En, rows.Qn, rows.begs
    overlap = mode == MODES["overlap"]

    def beg(r):
        return int(begs[r]) if r >= 0 else 0

    def score_at(r, c):
        x = c - beg(r)
        if not 0 <= x < BW:
            raise RuntimeError(f"backcal reads column {c} outside row {r}'s "
                               "band")
        return int(H[r, x] if r >= 0 else Hinit[x])

    def stored(r, x):
        """bsalign's u, e and q of row r at band position x."""
        if r < 0:
            u = us00 if x == 0 else int(Hinit[x] - Hinit[x - 1])
            return u, -128, -128 if pw == 2 else 0
        h = int(H[r, x])
        u = 0 if x == 0 else h - int(H[r, x - 1])
        return u, int(En[r, x]) - h, int(Qn[r, x]) - h if pw == 2 else 0

    out: List[int] = []
    cg = 0

    def push(op, sz):
        nonlocal cg
        if op == (cg & 0xF):
            cg += sz << 4
        else:
            if cg:
                out.append(cg)
            cg = (sz << 4) | op

    f = dict.fromkeys(FIELDS, 0)
    f["score"] = res["score"]
    qb, tb = res["qe"], res["te"]
    f["qe"], f["te"] = qb + 1, tb + 1
    Hs1 = score_at(tb, qb)
    Hs2 = 0
    prior_match = 0
    while True:
        if (Hs2 & 0xF) in (2, 4):     # a deletion run, first or second piece
            go, ge = (go1, ge1) if (Hs2 & 0xF) == 2 else (go2, ge2)
            Hs0 = score_at(tb, qb)
            if Hs0 + go + (Hs2 >> 4) * ge == Hs1:
                push(2, Hs2 >> 4)
                f["dele"] += Hs2 >> 4
                f["aln"] += Hs2 >> 4
                Hs1 = Hs0
                Hs2 = 0
            else:
                Hs2 += 1 << 4
                tb -= 1
                continue
        if qb < 0 or tb < 0:
            break
        if qb == beg(tb - 1):
            if qb:
                Hs0 = int(H[tb - 1, 0])
                prior_match = 0
            else:
                Hs0 = _boundary(mode, tb, pw, go1, ge1, go2, ge2)
        else:
            Hs0 = score_at(tb - 1, qb - 1)
        x = qb - beg(tb - 1)
        if 0 <= x < BW:
            u, e, qv = stored(tb - 1, x)
        else:
            u, e, qv = 0, go1 + ge1, 0
        h = Hs1 - Hs0
        s = int(mtx[q[qb], t[tb]])
        if x > BW:
            bt = 1
        elif x == BW:
            bt = 0 if h == s else 1
        else:
            order = ((0, 2, 4) if prior_match and not gap_first
                     else (2, 4, 0))
            bt = 1
            for op in order:
                if (op == 0 and h == s) or (op == 2 and h == u + e) or \
                        (op == 4 and pw == 2 and h == u + qv):
                    bt = op
                    break
        prior_match = 1
        if bt == 0:
            f["mat" if q[qb] == t[tb] else "mis"] += 1
            qb -= 1
            tb -= 1
            f["aln"] += 1
            push(0, 1)
            Hs1 = Hs0
        elif bt == 1:
            if qb <= 0:
                push(1, 1)
                Hs1 = Hs0
                qb -= 1
                f["ins"] += 1
                f["aln"] += 1
            else:
                sz = 1
                while sz + beg(tb) <= qb:
                    cost = go1 + sz * ge1
                    if pw == 2:
                        cost = max(cost, go2 + sz * ge2)
                    Hs0 = score_at(tb, qb - sz)
                    if Hs0 + cost == Hs1:
                        push(1, sz)
                        Hs1 = Hs0
                        qb -= sz
                        f["ins"] += sz
                        f["aln"] += sz
                        break
                    sz += 1
                else:
                    raise RuntimeError("backcal found no insertion run")
        else:
            Hs2 = (1 << 4) | bt
            tb -= 1
    if not overlap:
        if qb >= 0:
            push(1, qb + 1)
            f["ins"] += qb + 1
            f["aln"] += qb + 1
            qb = -1
        elif tb >= 0:
            push(2, tb + 1)
            f["dele"] += tb + 1
            f["aln"] += tb + 1
            tb = -1
    if cg:
        out.append(cg)
    f["qb"], f["tb"] = qb + 1, tb + 1
    return f, out[::-1]


def align(q, t, mode: str, W: int, match: int, mismatch: int, go1: int,
          ge1: int, go2: int = 0, ge2: int = 0, gap_first: bool = False):
    """(fields, packed CIGAR) of bsalign's `align` of query q on target t
    (codes 0-3): mode "global", "overlap" or "extend", band -W (0: the
    query's length rounded up to 128), gap costs as bsalign's negative
    -O/-E/-Q/-P."""
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    if q.size == 0 or t.size == 0 or q.max() > 3 or t.max() > 3:
        raise ValueError("the reference takes non-empty sequences of "
                         "codes 0-3")
    m = MODES[mode]
    BW = band_of(len(q), W)
    pw = piecewise(go1, ge1, go2, ge2, BW)
    if pw == 0:
        raise NotImplementedError("gap costs without an opening cost")
    mtx = score_matrix(match, mismatch)
    rows, Hinit, us00, res = forward(q, t, m, BW, mtx, go1, ge1, go2, ge2, pw)
    return backcal(q, t, m, BW, mtx, go1, ge1, go2, ge2, pw, rows, Hinit,
                   us00, res, gap_first)


def answer(params: dict, q, t, control: bool = False):
    """One pair's answer under a configuration's `align` flags (bsalign's
    -m, -W, -M, -X, -O, -E, -Q, -P): (fields as FIELDS, packed CIGAR).
    `control` breaks ties toward gaps (see the module's docstring)."""
    f, cg = align(q, t, params["mode"], params["W"], params["M"],
                  -params["X"], -params["O"], -params["E"], -params["Q"],
                  -params["P"], gap_first=control)
    return tuple(f[k] for k in FIELDS), tuple(cg)
