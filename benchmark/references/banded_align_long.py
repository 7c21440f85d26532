"""Plain reference of bsalign's banded pairwise alignment (`align`) for long
reads, in PyTorch: the semantics of `banded_align.py` at sizes whose rows
that module cannot hold. A 33 kb pair at band 32,768 has 1.08 G cells, and
`banded_align.py` keeps H, E and Q of each as int64: 26 GB.

The forward computes the same band rows, one row as one vector, in exact
int64 arithmetic, on the card when one is present and on the CPU
otherwise. The traceback is `banded_align.backcal` itself, reading the
rows through `Rows`. Taken from `banded_align.py` by import, not by copy,
so that every tie is broken as there: the band moves (`_band_mov`), the
column before the first (`_boundary`), the row before the first
(`_init_row`), the final row's maximum (`_row_max`), `backcal`,
`piecewise`, `band_of`, `score_matrix` and `FIELDS`.

Departures from `banded_align.forward`:

- rows are kept as int32 on the device the forward runs on, where every
  value fits (else it raises) and they take at most KEEP_BYTES: 8.65 GB of
  H and E for a 33 kb pair at band 32,768. Past that, the forward keeps
  only the state entering every BLOCK_ROWS-th row (H, the next row's E
  and Q, the band start and the pending move), and a block's rows are
  computed again from it when the traceback first reads them. Either way
  a block reaches the host when the traceback enters it: first the band
  positions within 2 x BLOCK_ROWS + 256 of the one it entered at, the
  whole band once it reads outside them. `Rows` holds the two blocks the
  traceback is in;
- F and G, the gap runs along a row, are `cummax` over the row where
  `banded_align.py` takes `np.maximum.accumulate`;
- the global mode's diagonal steering, the scores of the columns a band
  move uncovers and the per-row best end of overlap and extend are
  copies of `banded_align.forward`'s inline code, which no function there
  holds. The per-row best end is taken once after the last row: the first
  row whose query end holds the largest score, which is what the strict
  `>` of the row-by-row update keeps;
- a row's lane-boundary scores, which the band-move rule reads, are
  copied from the card only on rows where `_band_mov` reads them; it
  reads none while the band reaches the query's end.

It imports nothing of the program under test and no JAX.
"""
from __future__ import annotations

import importlib.util
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _sibling(name: str):
    """The module `name`.py beside this file, loaded once by path."""
    key = f"bench_references_{name}_for_long"
    if key not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


BA = _sibling("banded_align")
WS, NEG, SCORE_MIN, U32 = BA.WS, BA.NEG, BA.SCORE_MIN, BA.U32
MODES, FIELDS = BA.MODES, BA.FIELDS
piecewise, band_of, score_matrix = BA.piecewise, BA.band_of, BA.score_matrix
BLOCK_ROWS = 1024          # rows a block: computed, kept and copied
# the most bytes of int32 rows kept whole on the device the forward runs
# on (a 33 kb pair at band 32,768: 8.65 GB of H and E); past it, the state
# entering each block is kept and its rows computed again
KEEP_BYTES = {"cuda": 12 << 30, "cpu": 2 << 30}
I64 = torch.int64
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


class _LaneScores:
    """A row's score at band position 0 and at each stripe's last position,
    [H[0], H[W-1], H[2W-1], ...], copied from the device on first read."""

    def __init__(self, H: torch.Tensor, W: int):
        self.H, self.W, self.v = H, W, None

    def __getitem__(self, k: int) -> int:
        if self.v is None:
            self.v = torch.cat((self.H[:1], self.H[self.W - 1::self.W])
                               ).tolist()
        return self.v[k]


class _DP:
    """One pair's forward on one device: constants, scratch rows and the
    row step. A state is (Hx, E, Q): Hx [BW + 1] holds the row's H at
    1..BW, and slot 0 takes the next row's diagonal start; E and Q are the
    next row's gap scores (Q None without a second gap piece)."""

    def __init__(self, q, t, mode: int, BW: int, mtx, go1, ge1, go2, ge2,
                 pw: int, device):
        self.qlen, self.tlen = len(q), len(t)
        self.t = [int(x) for x in t]
        self.mode, self.BW, self.W, self.pw = mode, BW, BW // WS, pw
        self.gaps = (go1, ge1, go2, ge2)
        self.dev = device
        S = np.full((4, self.qlen + BW + 1), NEG, np.int64)
        S[:, :self.qlen] = mtx[q].T
        self.S_host = S
        self.S = torch.as_tensor(S, device=device)
        p = torch.arange(BW, dtype=I64, device=device)
        # gap runs along the row: a = H0 - ge * p, F[1:] = cummax(a)[:-1] +
        # go + ge * p[1:]
        self.runs = [(ge1 * p, go1 + ge1 * p[1:])]
        if pw == 2:
            self.runs.append((ge2 * p, go2 + ge2 * p[1:]))
        # the columns a band move uncovers (bsalign.h:2357-2390)
        go_, ge_ = (go2, ge2) if pw == 2 else (go1, ge1)
        self.c0 = (min(int(mtx.min()), go_ + ge_) - 1 - int(mtx.max())
                   + go_ + ge_)
        d = BA.c_div(go1 - go2, ge2 - ge1) if pw == 2 else BW + 1
        if not -128 <= self.c0 < 128:
            raise ValueError("gap costs outside what bsalign's int8 rows "
                             "hold")
        self.mim = (ge1 * p.clamp(max=d - 1)
                    + ge2 * (p - d + 1).clamp(min=0))
        self.diag, self.H0, self.a, self.run, self.tmp = (
            torch.empty(BW, dtype=I64, device=device) for _ in range(5))
        self.idx = torch.empty(BW, dtype=I64, device=device)
        self.F = torch.full((BW,), NEG, dtype=I64, device=device)
        Hinit, self.us00 = BA._init_row(mode, BW, pw, mtx, go1, ge1, go2,
                                        ge2)
        self.Hinit = Hinit
        self.init = (torch.cat((torch.zeros(1, dtype=I64),
                                torch.as_tensor(Hinit))).to(device),
                     torch.full((BW,), NEG, dtype=I64, device=device),
                     torch.full((BW,), NEG, dtype=I64, device=device)
                     if pw == 2 else None)

    def new_state(self, n: Optional[int] = None):
        """Buffers of one state, or of n states (rows of a block)."""
        lead = () if n is None else (n,)
        e = lambda w: torch.empty(lead + (w,), dtype=I64,  # noqa: E731
                                  device=self.dev)
        return e(self.BW + 1), e(self.BW), e(self.BW) if self.pw == 2 \
            else None

    @staticmethod
    def planes(buf, n: int):
        """H, En and Qn [n, BW] of the first n states of buf."""
        return (buf[0][:n, 1:],) + tuple(None if b is None else b[:n]
                                         for b in buf[1:])

    def rows(self, r0: int, n: int, rbeg: int, mov: int, prev, buf, begs,
             again: bool = False):
        """Rows r0..r0+n-1 into the first n rows of buf, from the state
        entering row r0; sets their band starts in begs (with `again`,
        checks them). Returns the band start, the pending move and the
        state after the last row."""
        buf[0][:n, 0] = 0
        for r in range(n):
            cur = (buf[0][r], buf[1][r], None if buf[2] is None else
                   buf[2][r])
            rbeg, mov = self.step(r0 + r, rbeg, mov, prev, cur, r == 0)
            if not again:
                begs[r0 + r] = rbeg
            elif rbeg != begs[r0 + r]:
                raise RuntimeError(f"row {r0 + r} computed again starts its "
                                   "band elsewhere")
            prev = cur
        return rbeg, mov, prev

    def step(self, i: int, rbeg: int, mov: int, prev, cur,
             first: bool) -> Tuple[int, int]:
        """Row i from the state entering it (prev, the band start rbeg and
        the pending move), written into cur; returns the row's band start
        and the move it sets for the next row (banded_align.forward's loop
        body). prev's slot 0 holds 0 unless `first`."""
        BW, qlen = self.BW, self.qlen
        go1, ge1, go2, ge2 = self.gaps
        Hx, E, Q = prev
        H = Hx[1:]
        if mov and rbeg + BW < qlen:
            mov = min(mov, max(0, qlen - (rbeg + BW)))
            rbeg += mov
            if mov >= BW:
                raise NotImplementedError("a band move past the whole band")
            mim = H[BW - 1] + (self.c0 + self.mim[:mov])
            Hs = torch.cat((H[mov:], mim))
            Es = torch.cat((E[mov:], mim))
            Qs = None if Q is None else torch.cat((Q[mov:], mim))
            srow = self.S[self.t[i], rbeg:rbeg + BW]
            torch.add(Hs[:-1], srow[1:], out=self.diag[1:])
            self.diag[:1] = (H[mov - 1:mov] + srow[:1]).clamp(min=NEG)
        else:
            mov = 0
            rh = NEG if rbeg else BA._boundary(self.mode, i, self.pw, go1,
                                               ge1, go2, ge2)
            Es, Qs = E, Q
            srow = self.S[self.t[i], rbeg:rbeg + BW]
            # diag[0] = max(rh + s0, NEG), diag[1:] = H[:-1] + srow[1:]
            s0 = int(self.S_host[self.t[i], rbeg])
            h0 = max(rh + s0, NEG) - s0
            if first or h0:
                Hx[0] = h0
            torch.add(Hx[:-1], srow, out=self.diag)
        H0 = self.H0
        torch.maximum(self.diag, Es, out=H0)
        if self.pw == 2:
            torch.maximum(H0, Qs, out=H0)
        Hn = cur[0][1:]
        src = H0
        for gep, gov in self.runs:
            torch.sub(H0, gep, out=self.a)
            torch.cummax(self.a, 0, out=(self.run, self.idx))
            torch.add(self.run[:-1], gov, out=self.F[1:])
            torch.maximum(src, self.F, out=Hn)
            src = Hn
        Hn.clamp_(min=NEG)
        # En = max(Es + ge1, H + go1 + ge1), Qn likewise with go2, ge2
        for nxt, s, go, ge in ((cur[1], Es, go1, ge1),
                               (cur[2], Qs, go2, ge2)):
            if nxt is None:
                continue
            torch.add(Hn, go, out=self.tmp)
            torch.maximum(s, self.tmp, out=nxt)
            nxt.add_(ge)
        ub = _LaneScores(Hn, self.W)
        if self.mode == MODES["global"]:
            tlen = self.tlen
            rbz = 2 * max(tlen // qlen, 1)
            rby = int((1.0 * i / tlen) * qlen)
            if rbeg + rbz * (tlen - i - 1) + BW <= ((qlen + rbz - 1) & U32):
                mov = (1 + (((qlen - (rbeg + BW)) & U32)
                            // max(1, tlen - i - 1))) & U32
            else:
                rbx = BA._band_mov(ub, self.W, i, rbeg, qlen)
                if rbeg < rby - BW:
                    mov = rbx + 1
                elif rbeg > rby:
                    mov = max(0, rbx - 1)
                else:
                    mov = rbx
        else:
            mov = BA._band_mov(ub, self.W, i, rbeg, qlen)
        return rbeg, mov


class _Block:
    """A block's rows on the host, read as value(plane, row, x): first a
    window of band positions around the column the traceback entered it
    at, all BW of them once it reads outside that window."""

    def __init__(self, planes, x: int, width: int):
        self.planes = planes          # (H, En, Qn) [n, BW] on the device
        self.BW = planes[0].shape[1]
        self._copy(max(0, x - width), min(self.BW, x + width + 1))

    def _copy(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.host = [None if p is None else p[:, lo:hi].cpu().numpy()
                     for p in self.planes]

    def value(self, k: int, off: int, x: int):
        if not self.lo <= x < self.hi:
            self._copy(0, self.BW)
        return self.host[k][off, x - self.lo]


class _Plane:
    """One of H, En, Qn of every row, read as plane[r, x]."""

    def __init__(self, rows: "Rows", k: int):
        self.rows, self.k = rows, k

    def __getitem__(self, rx):
        r, x = rx
        b, off = divmod(r, self.rows.block)
        return self.rows.block_at(b, x).value(self.k, off, x)


class Rows:
    """The forward's rows as backcal reads them (H, En, Qn indexed [r, x];
    begs[r]): each block's rows from the int32 rows kept on the device, or
    computed again from the block's kept state, copied to the host when
    the traceback first reads them. The traceback reads rows downward, so
    the two blocks last read are held."""

    def __init__(self, dp: _DP, block: int, begs: np.ndarray, store=None,
                 kept=None):
        self.dp, self.block, self.begs = dp, block, begs
        self.store, self.kept = store, kept
        self.H, self.En, self.Qn = (_Plane(self, k) for k in range(3))
        self._held: Dict[int, _Block] = {}
        self.computed = 0            # blocks computed again

    def block_at(self, b: int, x: int) -> _Block:
        if b not in self._held:
            if len(self._held) >= 2:
                del self._held[max(self._held)]
            self._held[b] = _Block(self._planes(b), x, 2 * self.block + 256)
        return self._held[b]

    def _planes(self, b: int):
        r0 = b * self.block
        n = min(self.block, self.dp.tlen - r0)
        if self.store is not None:
            return tuple(None if p is None else p[r0:r0 + n]
                         for p in self.store)
        prev, rbeg, mov = self.kept[b]
        buf = self.dp.new_state(n)
        self.dp.rows(r0, n, rbeg, mov, prev, buf, self.begs, again=True)
        self.computed += 1
        return self.dp.planes(buf, n)


def forward(dp: _DP, block: int = BLOCK_ROWS, keep: Optional[bool] = None):
    """(rows, AlnResult fields so far) of bsalign's banded forward. With
    `keep` (default: where they take at most KEEP_BYTES of the device the
    forward runs on) every row is kept as int32 on that device; else the
    state entering every `block`-th row, the rows computed again."""
    BW, qlen, tlen = dp.BW, dp.qlen, dp.tlen
    if block < 2:
        raise ValueError("blocks of 2 rows at least")
    buf = dp.new_state(block)
    if keep is None:
        planes = sum(b is not None for b in buf)
        keep = tlen * BW * 4 * planes <= KEEP_BYTES[dp.dev.type]
    store = tuple(None if b is None else
                  torch.empty((tlen, BW), dtype=torch.int32, device=dp.dev)
                  for b in buf) if keep else None
    kept = []
    begs = np.zeros(tlen, np.int64)
    ends = dp.mode != MODES["global"]
    last = torch.full((tlen,), NEG, dtype=I64, device=dp.dev)
    prev = dp.init
    rbeg = mov = 0
    for r0 in range(0, tlen, block):
        n = min(block, tlen - r0)
        if not keep:
            kept.append((tuple(None if x is None else x.clone()
                               for x in prev), rbeg, mov))
        rbeg, mov, prev = dp.rows(r0, n, rbeg, mov, prev, buf, begs)
        if keep:
            for dst, src in zip(store, dp.planes(buf, n)):
                if dst is not None:
                    lo, hi = torch.aminmax(src)
                    if int(lo) < I32_MIN or int(hi) > I32_MAX:
                        raise OverflowError("a score outside int32")
                    dst[r0:r0 + n].copy_(src)
        if ends:
            # H[qlen - 1 - rbeg] of each row whose band reaches the end
            at = np.nonzero(begs[r0:r0 + n] + BW >= qlen)[0]
            if len(at):
                r = torch.as_tensor(at, device=dp.dev)
                c = torch.as_tensor(qlen - begs[r0 + at], device=dp.dev)
                last[r0 + r] = buf[0][r, c]
    H = prev[0][1:]
    if not ends:
        res = {"score": int(H[qlen - 1 - rbeg]), "qe": qlen - 1,
               "te": tlen - 1}
    else:
        res = {"score": SCORE_MIN, "qe": 0, "te": 0}
        lv = last.cpu().numpy()
        i = int(np.argmax(lv))
        if lv[i] > SCORE_MIN:
            res = {"score": int(lv[i]), "qe": qlen - 1, "te": i}
        pos, m = BA._row_max(H.cpu().numpy(), dp.W)
        if m > res["score"]:
            res = {"score": m, "qe": rbeg + pos, "te": tlen - 1}
    return Rows(dp, block, begs, store if keep else None, kept), res


def align(q, t, mode: str, W: int, match: int, mismatch: int, go1: int,
          ge1: int, go2: int = 0, ge2: int = 0, gap_first: bool = False,
          block: int = BLOCK_ROWS, device=None, keep=None):
    """(fields, packed CIGAR) of bsalign's `align` of query q on target t,
    as `banded_align.align`, on `device` (default: the card when one is
    present); `block` and `keep` as `forward` takes them."""
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
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dp = _DP(q, t, m, BW, mtx, go1, ge1, go2, ge2, pw, torch.device(device))
    rows, res = forward(dp, block, keep)
    return BA.backcal(q, t, m, BW, mtx, go1, ge1, go2, ge2, pw, rows,
                      dp.Hinit, dp.us00, res, gap_first)


def answer(params: dict, q, t, control: bool = False):
    """One pair's answer under a configuration's `align` flags, as
    `banded_align.answer`: (fields as FIELDS, packed CIGAR)."""
    f, cg = align(q, t, params["mode"], params["W"], params["M"],
                  -params["X"], -params["O"], -params["E"], -params["Q"],
                  -params["P"], gap_first=control)
    return tuple(f[k] for k in FIELDS), tuple(cg)
