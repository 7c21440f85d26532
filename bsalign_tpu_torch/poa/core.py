"""BSPOA: banded striped partial-order alignment / consensus / SNV engine
(port of bsalign_tpu.poa.core).

A from-scratch reimplementation of the reference pipeline (bspoa.h):
  beg/push/end -> kmer shuffle -> incremental graph alignment (banded striped
  DP rows per node, topological order, row merge on in-degree>1, traceback
  fusing matches into aligned rings) -> topological MSA extraction -> 5-state
  HMM consensus with qualities -> profile realignment rounds -> SNV calling.

Numeric semantics (int8-saturated DP rows, double-precision HMM, float32 SNV
histograms, unstable-sort tie orders) match the reference exactly; the hot DP
kernels run in the host C++ (native/rowops.cpp), except the profile DP of
each realignment round (remsa_pedits), which runs for every read of the
round in one batch on the engine's device: the hand-written CUDA kernel on
a CUDA device, its plain PyTorch version on the CPU (ops/pedit.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..cigar import AlnResult
from ..constants import (MODE_GLOBAL, MODE_OVERLAP, SCORE_MIN, WORDSIZE,
                         mode_type, roundup)
from ..native import rowops as NR
from ..ops.pedit import PeditJob, pedit_forward_batch
from ..oracle import banded8 as B8
from ..oracle import edit as OE
from .csort import c_sort_array, shuffle_array
from .graph import Graph

WS = WORDSIZE

QLT_MAX = 90
MAX_U4 = 0xFFFFFFFF


@dataclass
class BSPOAPar:
    refmode: int = 0
    shuffle: int = 1
    alnmode: int = MODE_OVERLAP
    realn: int = 3
    seqcore: int = 40
    nrec: int = 20
    ksz: int = 15
    bwtrigger: int = 1
    bandwidth: int = 128
    M: int = 2
    X: int = -6
    O: int = -3
    E: int = -2
    Q: int = -8
    P: int = -1
    T: int = 20
    refbonus: int = 1
    editbw: int = 64
    althi: int = 5
    qlthi: int = 70
    psub: float = 0.10
    pins: float = 0.10
    pdel: float = 0.15
    piex: float = 0.15
    pdex: float = 0.20
    hins: float = 0.20
    hdel: float = 0.40
    min_varcnt: int = 3
    min_covfrq: float = 0.5
    min_snvqlt: int = 5


def _remsa_stale_start(pad: int) -> int:
    """First T-plane index the reference's per-read scratch clear misses.

    remsa_pedits_bspoa clears 4*(mlen+bw) bytes over four count planes
    spaced roundup16(mlen+bw) apart (bspoa.h:4348), so when mlen+bw is not
    a multiple of 16 the last 3*(roundup16-pad) entries of the 4th (T)
    plane keep the previous read's homopolymer counts. The DP reads those
    counts, so byte-exact output requires carrying them over identically.
    """
    pad16 = roundup(pad, WS)
    return max(0, min(pad, 4 * pad - 3 * pad16))


def gen_dptable(par: BSPOAPar):
    """Event table: (cur cns, cur read, last cns base, last state) -> event
    (bspoa.h:142-204). `1 - psub` is float32 arithmetic in C (int promotes
    to float, not double), so compute it at float32 before the log."""
    os_ = [float(np.float32(1) - np.float32(par.psub)), par.psub, par.pins,
           par.pdel, par.piex, par.pdex, par.hins, par.hdel]
    ps = [math.log(x) for x in os_]
    table = np.zeros(5 * 5 * 5 * 5, dtype=np.uint8)
    for i in range(5 ** 4):
        a = i % 5
        b = (i // 5) % 5
        c = (i // 25) % 5
        d = (i // 125) % 5
        if a < 4:
            if b < 4:
                if a == b:
                    table[i] = (0 << 3) | 0
                else:
                    table[i] = (1 << 3) | 0
            else:
                if d == 2:
                    if a == c and ps[7] > ps[5]:
                        table[i] = (7 << 3) | 2
                    else:
                        table[i] = (5 << 3) | 2
                else:
                    if a == c and ps[7] > ps[3]:
                        table[i] = (7 << 3) | 2
                    else:
                        table[i] = (3 << 3) | 2
        else:
            if b < 4:
                if d == 1:
                    if b == c and ps[6] > ps[4]:
                        table[i] = (6 << 3) | 1
                    else:
                        table[i] = (4 << 3) | 1
                else:
                    if b == c and ps[6] > ps[2]:
                        table[i] = (6 << 3) | 1
                    else:
                        table[i] = (2 << 3) | 1
            else:
                table[i] = (0 << 3) | d
    return ps, os_, table


_log_caches = [0.0]


def cal_permutation(n: int, m: int) -> float:
    if n > 1000:
        return 1.0
    while len(_log_caches) <= n:
        _log_caches.append(_log_caches[-1] + math.log(len(_log_caches)))
    return _log_caches[n] - _log_caches[m] - _log_caches[n - m]


def cal_binomial(n: int, m: int, p: float) -> float:
    return math.log(p) * m + math.log(1 - p) * (n - m) + cal_permutation(n, m)


class BSPOA:
    """One POA window. `device` is where each realignment round's profile
    DP runs (a CUDA device: the kernel; the CPU: its plain version); the
    rest of the engine runs on the host."""

    def __init__(self, par: BSPOAPar = None, *, device):
        self.device = device
        self.par = par if par is not None else BSPOAPar()
        self.par.bandwidth = roundup(self.par.bandwidth, WS)
        # the reference stores probabilities as C floats (bspoa.h:69-71);
        # every use promotes float->double, so round-trip through float32
        for fld in ("psub", "pins", "pdel", "piex", "pdex", "hins", "hdel",
                    "min_covfrq"):
            setattr(self.par, fld, float(np.float32(getattr(self.par, fld))))
        self.dpvals, self.dporis, self.dptable = gen_dptable(self.par)
        self.keep_seqs = False
        self._reset()

    def _reset(self):
        self.seqs: List[np.ndarray] = []  # 2-bit code arrays
        self.cigars: List[List[int]] = []
        self.g = Graph()
        self.ords: List[int] = []
        self.nmsa = 0
        self.nrds = 0
        self.backbone = 0
        self.msacols: Optional[np.ndarray] = None  # [mlen, mrow] uint8
        self.msaidxs: List[int] = []
        self.cns = np.zeros(0, np.uint8)
        self.qlt = np.zeros(0, np.uint8)
        self.alt = np.zeros(0, np.uint8)
        self.var: List[dict] = []
        # alignment scratch
        self.sels: List[int] = []
        self.states_map = np.zeros(0, np.uint8)
        self.todels: List[Tuple[int, int]] = []
        self.rdregs0: List[int] = []
        self.rdregs1: List[int] = []
        self.qseq = np.zeros(0, np.uint8)
        self.qlen = self.slen = 0
        self.qb = self.qe = 0
        self.bandwidth = 0
        self.piecewise = 1
        self.qprof = [None] * 4
        self.maxscr = SCORE_MIN
        self.maxidx = -1
        self.maxoff = -1

    # ------------------------------------------------------------------ API
    def beg(self):
        if self.keep_seqs:
            self.keep_seqs = False
            seqs = self.seqs
            cigars = self.cigars
            cns, qlt, alt = self.cns, self.qlt, self.alt
            self._reset()
            self.seqs = seqs
            self.cigars = cigars
            self.cns, self.qlt, self.alt = cns, qlt, alt
        else:
            self._reset()
        if not self.par.refmode:
            self.push_codes(np.zeros(0, np.uint8))

    def push(self, seq: str):
        from ..seqs import encode_dna
        self.push_codes(encode_dna(seq))

    def push_codes(self, codes: np.ndarray, cgs: Optional[List[int]] = None):
        if len(self.seqs) >= 0x3FFF:
            return
        self.seqs.append(np.asarray(codes, np.uint8) & 3)
        self.cigars.append(list(cgs) if cgs else [])
        self.rdregs0.append(0)
        self.rdregs1.append(len(codes))

    @property
    def nseq(self) -> int:
        return len(self.seqs)

    def rdlen(self, rid: int) -> int:
        return len(self.seqs[rid])

    # ------------------------------------------------- read node ingestion
    def _add_read_core(self, rid: int):
        g = self.g
        seq = self.seqs[rid]
        length = len(seq)
        g.new_node(rid, -1, 4)
        g.ndoffs.append(len(g.nodes))
        if length:
            g.new_nodes_bulk(rid, 0, np.asarray(seq, np.int32))
        g.new_node(rid, length, 4)
        if rid == 0:
            self.backbone = length
            g.HEAD = g.ndoffs[rid] - 1
            g.nodes[g.HEAD].cpos = 0
            g.TAIL = g.ndoffs[rid] + length
            g.nodes[g.TAIL].cpos = length
            from .graph import ND_BLESS, ND_CPOS, ND_REF
            base0 = g.ndoffs[0]
            g._nd[ND_REF][base0:base0 + length] = 1
            g._nd[ND_BLESS][base0:base0 + length] = 1
            g._nd[ND_CPOS][base0:base0 + length] = np.arange(
                length, dtype=np.int32)
            NR.g_connect_range(g, 0, 0, length)
        else:
            g.merge_nodes(g.HEAD, g.rdnode(rid, -1))
            g.merge_nodes(g.TAIL, g.rdnode(rid, length))

    # --------------------------------------------------------- kmer shuffle
    def shuffle_reads_by_kmers(self):
        nseq = self.nseq
        if nseq == 0:
            return
        ksize = self.par.ksz
        kmask = MAX_U4 >> ((16 - ksize) << 1)
        mincnt = 1 if self.par.refmode else max(2, int(nseq * 0.05))

        def read_kmers(seq):
            if ksize == 0:
                # reference quirk (bspoa.h:1016-1034): ksz=0 makes
                # `MAX_U4 >> ((16-ksz)<<1)` a shift by 32, which x86
                # masks to a shift by 0 — kmask = all ones — and the
                # `i + 1 < ksize` skip never fires, so ksz=0 behaves as
                # a rolling 16-mer that also emits the 15 ramp-up
                # prefixes. Leading-zero padding reproduces the ramp-up
                # exactly (absent bases contribute 0, same as base A).
                if len(seq) == 0:
                    return np.zeros(0, np.int64)
                padded = np.zeros(len(seq) + 15, np.int64)
                padded[15:] = np.asarray(seq, np.int64)
                win = np.lib.stride_tricks.sliding_window_view(padded, 16)
                wf = (4 ** np.arange(15, -1, -1)).astype(np.int64)
                return win @ wf
            m = len(seq) - ksize + 1
            if m <= 0:
                return np.zeros(0, np.int64)
            win = np.lib.stride_tricks.sliding_window_view(
                np.asarray(seq, np.int64), ksize)
            wf = (4 ** np.arange(ksize - 1, -1, -1)).astype(np.int64)
            return win @ wf

        # occurrence hash semantics (bspoa.h:1003-1100): per kmer, total
        # count across reads + a sticky "repeated within one read" flag
        # (rid-field comparison in the scalar loop <=> per-(kmer, read)
        # multiplicity >= 2, since reads are scanned one at a time)
        rk = [read_kmers(self.seqs[r])
              for r in range(1 if self.par.refmode else nseq)]
        if rk and sum(len(k) for k in rk):
            K = np.concatenate(rk)
            R = np.concatenate([np.full(len(k), r, np.int64)
                                for r, k in enumerate(rk)])
            order = np.lexsort((R, K))
            Ks, Rs = K[order], R[order]
            newk = np.empty(len(Ks), bool)
            newk[0] = True
            newk[1:] = Ks[1:] != Ks[:-1]
            starts = np.flatnonzero(newk)
            cnts = np.diff(np.append(starts, len(Ks)))
            samepair = np.zeros(len(Ks), bool)
            samepair[1:] = (Ks[1:] == Ks[:-1]) & (Rs[1:] == Rs[:-1])
            rep = np.add.reduceat(samepair, starts) > 0
            good = (~rep) & (cnts >= mincnt)
            qual = Ks[starts[good]]          # sorted qualifying kmers
        else:
            qual = np.zeros(0, np.int64)
        logv = math.log(1.2)
        kords = np.zeros(nseq, np.float32)
        kords[0] = np.float32(3e38)
        kidxs = [0]
        for ridx in range(1, nseq):
            seq = self.seqs[ridx]
            ks = read_kmers(seq)
            if len(ks) and len(qual):
                pos = np.searchsorted(qual, ks)
                pos = np.minimum(pos, len(qual) - 1)
                khit = int((qual[pos] == ks).sum())
            else:
                khit = 0
            # C float semantics: log(0) = -inf, 0/-inf = -0.0 (an empty
            # read can reach here on keep_seqs re-runs)
            with np.errstate(divide="ignore", invalid="ignore"):
                if self.par.refmode:
                    denom = np.log(np.float64(max(len(seq), self.rdlen(0))))
                else:
                    denom = np.log(np.float64(len(seq)))
                v = np.float64(khit) * logv / denom
            kords[ridx] = np.float32(0.0 if np.isnan(v) else v)
            kidxs.append(ridx)
        c_sort_array(kidxs, lambda a, b: kords[b] > kords[a])
        self.ords = list(kidxs)
        shuffle_array(self.seqs, kidxs)
        shuffle_array(self.cigars, kidxs)

    def restore_rd_orders(self):
        nseq = self.nseq
        revs = self.ords
        ords = [0] * nseq
        for i in range(nseq):
            ords[revs[i]] = i
        shuffle_array(self.seqs, ords)
        shuffle_array(self.g.ndoffs, ords)
        shuffle_array(self.cigars, ords)
        g = self.g
        from .graph import ND_RID
        RID = g._nd[ND_RID]
        for i in range(nseq):
            v = g.rdnode(i, -1)
            ve = g.rdnode(i, self.rdlen(i))
            RID[v:ve + 1] = i

    # ------------------------------------------------------------ alignment
    def sel_nodes(self, nhead: int, ntail: int, ridxbeg: int, ridxend: int):
        g = self.g
        sels, smap, pairs = NR.sel_nodes(
            g, nhead, ntail, ridxbeg, ridxend, self.nmsa,
            np.asarray(g.ndoffs, np.int64))
        self.sels = sels             # int32 ndarray
        self.states_map = smap
        self.todels.extend(pairs)
        return len(sels)

    def _in_states(self, nidx: int) -> bool:
        """Selected-subgraph membership: the per-node byte map that
        sel_nodes sets."""
        smap = self.states_map
        return nidx < len(smap) and bool(smap[nidx])

    def prepare_rd_align(self, par: BSPOAPar, nhead: int, ntail: int,
                         rid: int, rbeg: int, rend: int):
        g = self.g
        nhead = g.nodes[nhead].header
        ntail = g.nodes[ntail].header
        seqlen = rend - rbeg
        self.qlen = self.slen = seqlen
        self.qb = 0
        self.qe = self.qlen
        self.qseq = self.seqs[rid][rbeg:rend].copy()
        reflen = self.backbone if par.refmode else len(self.cns)
        tb, te = 0, reflen
        cgs = None
        if par.bandwidth == 0:
            self.bandwidth = roundup(seqlen, WS)
        else:
            self.bandwidth = roundup(min(par.bandwidth, seqlen), WS)
        if par.bwtrigger and nhead == g.HEAD and ntail == g.TAIL:
            if par.refmode and self.cigars[rid]:
                # caller-supplied read-vs-backbone CIGAR places the band
                # (bspoa.h:2053-2087): strip soft/hard-clip + indel margins
                # from both ends, then the retained runs drive the rmap
                cgs_full = self.cigars[rid]
                x = y = 0
                i = 0
                while i < len(cgs_full):
                    op = cgs_full[i] & 0xF
                    sz = cgs_full[i] >> 4
                    if op in (2, 3, 5):       # D/N/H consume ref
                        y += sz
                    elif op in (1, 4):        # I/S consume read
                        x += sz
                    else:
                        break
                    i += 1
                cgs2 = cgs_full[i:]
                self.qb = x
                tb = y
                x = y = 0
                i = len(cgs2)
                while i > 0:
                    op = cgs2[i - 1] & 0xF
                    sz = cgs2[i - 1] >> 4
                    if op in (2, 3, 5):
                        y += sz
                    elif op in (1, 4):
                        # the reference reads cgs[i] here (bspoa.h:2077), an
                        # off-by-one into the next entry; we use the intended
                        # run being classified
                        x += sz
                    else:
                        break
                    i -= 1
                cgs2 = cgs2[:i]
                self.qe = self.qlen - x
                self.slen = self.qe - self.qb
                te = self.backbone - y
                x, y = 0, tb
                tb = tb - self.bandwidth // 4 \
                    if tb >= self.bandwidth // 2 else 0
                te = te + self.bandwidth // 4 \
                    if reflen - te >= self.bandwidth // 2 else reflen
                cgs = cgs2
            elif len(self.cns) and roundup(seqlen, WS) > par.bandwidth:
                if par.ksz:
                    rs, cg = OE.kmer_edit_pairwise(par.ksz, self.qseq, self.cns)
                else:
                    rs, cg = OE.edit_pairwise(self.qseq, self.cns,
                                              par.alnmode, 0)
                self.qb = rs.qb
                self.qe = rs.qe
                self.slen = self.qe - self.qb
                tb = rs.tb - self.bandwidth // 4 \
                    if rs.tb >= self.bandwidth // 2 else 0
                te = rs.te + self.bandwidth // 4 \
                    if len(self.cns) - rs.te >= self.bandwidth // 2 \
                    else len(self.cns)
                cgs = cg
                x, y = 0, rs.tb
            else:
                self.bandwidth = roundup(seqlen, WS)
        else:
            self.bandwidth = roundup(seqlen, WS)
        from .graph import ND_CPOS, ND_MMIDX, ND_NCT, ND_RPOS
        nd = g._nd
        sarr = np.asarray(self.sels, np.int64)
        if cgs:
            rmap = np.zeros(reflen + 1, np.int64)
            if y > 1:
                ii = np.arange(1, y, dtype=np.int64)
                rmap[1:y] = ii * self.qb // (y + 1)
            # vectorized run walk (one pass instead of a per-run loop):
            # M-type runs write x+0..sz-1 at y..y+sz-1, D-type write x
            cga = np.asarray(cgs, np.int64)
            ops = cga & 0xF
            szs = cga >> 4
            is_m = (ops == 0) | (ops == 7) | (ops == 8)
            is_d = (ops == 2) | (ops == 3) | (ops == 5)
            qadv = np.where(is_m | (ops == 1) | (ops == 4), szs, 0)
            radv = np.where(is_m | is_d, szs, 0)
            x0 = x + np.cumsum(qadv) - qadv
            y0 = y + np.cumsum(radv) - radv
            sel = is_m | is_d
            if np.any(sel):
                szs_s = szs[sel]
                tot = int(szs_s.sum())
                off = (np.arange(tot, dtype=np.int64)
                       - np.repeat(np.cumsum(szs_s) - szs_s, szs_s))
                ypos = np.repeat(y0[sel], szs_s) + off
                vals = np.repeat(x0[sel], szs_s) \
                    + np.where(np.repeat(is_m[sel], szs_s), off, 0)
                rmap[ypos] = vals
            x += int(qadv.sum())
            y += int(radv.sum())
            if reflen > y:
                jj = np.arange(y, reflen, dtype=np.int64)
                rmap[y:reflen] = x + (jj - y + 1) * (self.slen - x) \
                    // (reflen - y + 1)
            rmap[reflen] = self.slen
            cpos_arr = nd[ND_CPOS][sarr].astype(np.int64)
            if self.bandwidth >= self.slen:
                nd[ND_RPOS][sarr] = 0
            else:
                nd[ND_RPOS][sarr] = np.clip(
                    rmap[cpos_arr] - self.bandwidth // 2, 0,
                    self.slen - self.bandwidth)
            # bridge the first selected node at the kmer-chained band ends
            # to HEAD/TAIL (bspoa.h:1910-1940): only the first match counts
            if tb:
                hit = np.flatnonzero(cpos_arr == tb)
                if len(hit):
                    nidx = int(sarr[hit[0]])
                    _, exists = g.chg_edge(nhead, nidx, 1)
                    self.todels.append((nhead, nidx))
                    if exists == 0 and self._in_states(nhead) \
                            and self._in_states(nidx):
                        nd[ND_NCT][nidx] += 1
            if te != reflen:
                hit = np.flatnonzero(cpos_arr == te)
                if len(hit):
                    nidx = int(sarr[hit[0]])
                    _, exists = g.chg_edge(nidx, ntail, 1)
                    self.todels.append((int(g.nodes[nidx].header), ntail))
                    if exists == 0 and self._in_states(ntail) \
                            and self._in_states(nidx):
                        nd[ND_NCT][ntail] += 1
        else:
            nd[ND_RPOS][sarr] = 0
        qsub = self.qseq[self.qb:self.qe]
        self.qprof = NR.qprof4(qsub, self.slen, self.bandwidth, par.M, par.X,
                               par.refbonus)
        self.piecewise = B8.get_piecewise(par.O, par.E, par.Q, par.P,
                                          self.bandwidth)
        mmcnt = 2 + len(sarr)
        nd[ND_MMIDX][sarr] = np.arange(2, mmcnt, dtype=np.int32)
        W = self.bandwidth // WS
        init = B8.row_init(par.alnmode, self.bandwidth,
                           par.M + par.refbonus + 1, par.X, par.O, par.E,
                           par.Q, par.P)
        self.arena = NR.RowArena(mmcnt, W, self.piecewise)
        self._qpp = [q.ctypes.data for q in self.qprof]
        slot = g.nodes[nhead].mmidx
        self.arena.set_from(slot, init)
        self.maxscr = SCORE_MIN
        self.maxidx = -1
        self.maxoff = -1

    def _states_map(self):
        """The selected-subgraph byte map, grown to the node count."""
        smap = self.states_map
        n = len(self.g.nodes)
        if len(smap) < n:
            smap = np.concatenate([smap, np.zeros(n - len(smap), np.uint8)])
        return smap

    def align_rd_core(self, par: BSPOAPar, rid: int, nhead: int, ntail: int):
        """Forward row DP over the selected subgraph (host C++)."""
        g = self.g
        W = self.bandwidth // WS
        best = np.array([self.maxscr, self.maxidx, self.maxoff], np.int64)
        NR.align_rd_core(
            g, np.asarray(self.sels, np.int32), self._states_map(),
            self.arena, self._qpp, W, self.bandwidth, self.slen,
            self.piecewise, par.M + par.refbonus + 1, par.X, par.O, par.E,
            par.Q, par.P, par.T, int(mode_type(par.alnmode) == MODE_OVERLAP),
            int(mode_type(par.alnmode) == MODE_GLOBAL), nhead, ntail, best)
        self.maxscr = int(best[0])
        self.maxidx = int(best[1])
        self.maxoff = int(best[2])
        return self.maxscr

    def alignment2graph(self, par: BSPOAPar, rid: int, rbeg: int, nhead: int,
                        ntail: int, midx: int, xe: int) -> AlnResult:
        """Graph traceback and ring fusion (host C++)."""
        g = self.g
        return NR.alignment2graph(
            g, self.arena, self._qpp, self._states_map(),
            np.asarray(g.ndoffs, np.int64), self.bandwidth // WS,
            self.bandwidth, self.qlen, self.qb, self.piecewise, par.O, par.E,
            par.Q, par.P, int(mode_type(par.alnmode) == MODE_OVERLAP), nhead,
            ntail, midx, xe, rid, rbeg, AlnResult())

    def align_rd(self, par: BSPOAPar, realn: int, rid: int, rbeg: int,
                 rlen: int) -> AlnResult:
        g = self.g
        if (rlen > 0
                and not (par.refmode and self.cigars[rid])
                and not (par.ksz == 0 and par.bwtrigger and len(self.cns)
                         and roundup(rlen, WS) > par.bandwidth)):
            # whole-read call: sel + band placement + row DP + graph merge
            # in one C++ call; semantics identical to the staged path below
            self.todels = []
            return NR.align_rd_full(g, self.seqs[rid], self.cns, par,
                                    self.nmsa, rid, rbeg, rbeg + rlen,
                                    realn)
        if realn and rid:
            NR.g_cut_range_asc(g, rid, rbeg, rbeg + rlen, 3)
        self.todels = []
        if rlen == 0:
            return AlnResult()
        nhead = g.nodes[g.rdnode(rid, rbeg - 1)].header
        ntail = g.nodes[g.rdnode(rid, rbeg + rlen)].header
        if realn == 0 and par.nrec:
            ridxbeg = max(0, rid - par.nrec - 1)
            ridxend = rid
        else:
            ridxbeg = 0
            ridxend = 0xFFFF
        self.sel_nodes(nhead, ntail, ridxbeg, ridxend)
        self.prepare_rd_align(par, nhead, ntail, rid, rbeg, rbeg + rlen)
        score = self.align_rd_core(par, rid, nhead, ntail)
        rs = self.alignment2graph(par, rid, rbeg, nhead, ntail, self.maxidx,
                                  self.maxoff)
        rs.qb += self.qb
        rs.qe += self.qb
        rs.score = score
        for a, b in self.todels:
            g.chg_edge(a, b, -1)
        self.todels = []
        return rs

    # --------------------------------------------------- MSA extraction
    def sort_nodes(self) -> int:
        """Reverse-topological longest-path column assignment
        (bspoa.h:2695-2946), in the host C++."""
        mlen = NR.sort_nodes(self.g)
        self.msaidxs = list(range(mlen))
        self.msacols = np.full((mlen, self.nseq + 3), 4, np.uint8)
        return mlen

    def msa(self) -> int:
        """Fill the column-major base matrix (bspoa.h:3156-3248)."""
        g = self.g
        nseq = self.nrds
        mlen = self.sort_nodes()
        mrow = self.msacols.shape[1]
        midx = np.asarray(self.msaidxs, np.int64)
        NR.msa_fill(g, self.msacols, midx, mlen, mrow)
        if mlen and nseq:
            NR.mask_lead_tail(self.msacols, midx, mlen, mrow, nseq)
        return mlen

    # ------------------------------------------------------------ consensus
    def simple_cns(self):
        """Majority vote (bspoa.h:3312-3388), in the host C++."""
        g = self.g
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        if mlen == 0:
            return
        from .graph import ND_CPOS
        bsel = NR.simple_cns(self.msacols, np.asarray(self.msaidxs, np.int64),
                             mlen, self.msacols.shape[1], nseq, nall,
                             g._nd[ND_CPOS], np.asarray(g.ndoffs, np.int64))
        self.cns = bsel[bsel < 4].astype(np.uint8)
        self.qlt = np.zeros(len(self.cns), np.uint8)
        self.alt = np.zeros(len(self.cns), np.uint8)
        g.nodes[g.HEAD].cpos = 0
        g.nodes[g.TAIL].cpos = len(self.cns)

    def cns_call(self) -> float:
        """5-state HMM consensus + QLT/ALT qualities (bspoa.h:3457-3733),
        in the host C++."""
        min_freq_calq = 0.1
        nseq = min(self.nmsa, self.nrds)
        nmax = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        if mlen == 0:
            raise RuntimeError("cns_call on an empty MSA")
        midx = np.asarray(self.msaidxs, np.int64)
        if np.array_equal(midx, np.arange(len(self.msacols))):
            colmat = np.ascontiguousarray(self.msacols, np.uint8)
        else:
            colmat = np.ascontiguousarray(self.msacols[midx], np.uint8)
        sc, btm, _ = NR.cns_forward(
            colmat, nseq, np.ascontiguousarray(self.dptable, np.uint8),
            np.ascontiguousarray(self.dpvals, np.float64), min_freq_calq)
        self.cns, self.qlt, self.alt, ret = NR.cns_tail(
            sc, btm, self.msacols, midx, mlen, nall, nmax, self.par.psub,
            QLT_MAX)
        self._cns_cpos_writeback(nall)
        return ret

    def _cns_cpos_writeback(self, nall):
        g = self.g
        if not g.nodes:
            return
        from .graph import ND_CPOS
        CPOS = g._nd[ND_CPOS]
        order = np.asarray(self.msaidxs, np.int64)
        mat = self.msacols[order]
        cnsrow = mat[:, nall] < 4
        cpos_at = np.concatenate([[0], np.cumsum(cnsrow)[:-1]])
        for rid in range(min(nall, len(g.ndoffs))):
            sel = mat[:, rid] < 4
            k = int(sel.sum())
            if k:
                CPOS[g.ndoffs[rid]: g.ndoffs[rid] + k] = cpos_at[sel]
        g.nodes[g.HEAD].cpos = 0
        g.nodes[g.TAIL].cpos = len(self.cns)

    # ----------------------------------------------- MSA helper nodes
    def add_msanodes(self):
        """Add cns-as-read + 4 per-base rail reads (bspoa.h:3068-3154)."""
        g = self.g
        if len(g.ndoffs) > self.nseq:
            self.del_msanodes()
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        clen = 0
        u = g.new_node(nall, -1, 4)
        g.merge_nodes(u, g.HEAD)
        g.ndoffs.append(len(g.nodes))
        order = np.asarray(self.msaidxs, np.int64)
        if mlen:
            cnsnode0 = len(g.nodes)
            cns_bases = self.msacols[order, nall]
            kept = cns_bases[cns_bases < 4].astype(np.int32)
            if len(kept):
                g.new_nodes_bulk(nall, 0, kept)
            clen = NR.msanode_cns_merges(
                g, self.msacols, order, mlen, self.msacols.shape[1], nall,
                nseq, np.asarray(g.ndoffs, np.int64), cnsnode0)
        u = g.new_node(nall, clen, 4)
        g.merge_nodes(u, g.TAIL)
        NR.g_connect_range(g, nall, 0, clen)
        self.rdregs0.append(0)
        self.rdregs1.append(clen)
        from .graph import ND_MPOS
        for i in range(4):
            u = g.new_node(nall + 1 + i, -1, i)
            g.merge_nodes(u, g.HEAD)
            g.ndoffs.append(len(g.nodes))
            i0 = g.new_nodes_bulk(nall + 1 + i, 0,
                                  np.full(mlen, i, np.int32))
            g._nd[ND_MPOS][i0:i0 + mlen] = np.arange(mlen, dtype=np.int32)
            u = g.new_node(nall + 1 + i, mlen, i)
            g.merge_nodes(u, g.TAIL)
            self.rdregs0.append(0)
            self.rdregs1.append(mlen)
        if mlen:
            NR.msanode_rail_merges(
                g, self.msacols, order, mlen, self.msacols.shape[1], nall,
                nseq, np.asarray(g.ndoffs, np.int64))

    def del_msanodes(self):
        g = self.g
        nseq = self.nseq
        if len(g.ndoffs) < nseq + 5:
            return
        for j in range(4, -1, -1):
            clen = len(g.nodes) - g.ndoffs[nseq + j] - 1
            NR.g_cut_range_asc(g, nseq + j, -1, clen + 1, 3)
            del g.nodes[g.ndoffs[nseq + j] - 1:]
            del g.ndoffs[nseq + j:]
            del self.rdregs0[nseq + j:]
            del self.rdregs1[nseq + j:]

    # ------------------------------------------------ profile realignment
    def remsa_pedits(self, bandwidth: int, hpadjust: int, all_: int) -> None:
        """Anti-diagonal max-match realignment vs the column profile
        (bspoa.h:4178-4457): build every read's job, run all their forward
        DPs in one batch on the engine's device, then apply the tracebacks
        to the graph in order. The lockstep driver (poa/batch.py) runs the
        same three steps with many windows' jobs in one batch."""
        ctx = self._remsa_prepare(bandwidth, hpadjust)
        if ctx is None:
            return
        jobs, spec = self._remsa_dev_build(ctx, all_)
        mats = pedit_forward_batch(jobs, device=self.device) if jobs else []
        self._remsa_dev_apply(ctx, spec, mats, all_)

    def _remsa_prepare(self, bandwidth: int, hpadjust: int):
        """Build this round's MSA column profile (bspoa.h:4199-4319);
        returns a ctx dict or None on early-out."""
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        if nseq >= 255:
            return None
        bandwidth = roundup(bandwidth, WS)
        HW = bandwidth // 2
        self.add_msanodes()
        pad = mlen + bandwidth
        rowlen = bandwidth + 2
        seqs1 = np.zeros(pad, np.uint8)
        mats1 = np.zeros((4, pad), np.int64)  # counts; stored u1i in C
        # base offsets: logical index i maps to buffer [HW + i]
        order = np.asarray(self.msaidxs, np.int64)
        mat = self.msacols[order]
        seqs1[HW:HW + mlen] = mat[::-1, nall]
        sub = mat[:, :nseq]
        for b in range(4):
            mats1[b, HW:HW + mlen] = (sub == b).sum(axis=1)
        np.minimum(mats1, 255, out=mats1)  # u1i semantics (counts < nseq < 255)
        if hpadjust:
            cnsrow = np.ascontiguousarray(mat[:, nall], np.uint8)
            cnt = np.ascontiguousarray(mats1[:4, HW:HW + mlen].T, np.int64)
            NR.hp_adjust(mlen, cnsrow, cnt, True)
            mats1[:4, HW:HW + mlen] = cnt.T
        # reverse mats1 over [0, mlen)
        mats1[:, HW:HW + mlen] = mats1[:, HW:HW + mlen][:, ::-1]
        mats1 = mats1.astype(np.uint8)
        return dict(nseq=nseq, mlen=mlen, bandwidth=bandwidth, HW=HW,
                    pad=pad, rowlen=rowlen, seqs1=seqs1, mats1=mats1)

    def _remsa_dev_build(self, ctx, all_):
        """Per-read pedit jobs for this round (order-independent forward
        DPs over the shared column profile)."""
        g = self.g
        nseq, mlen = ctx["nseq"], ctx["mlen"]
        pad, HW = ctx["pad"], ctx["HW"]
        seqs1, mats1 = ctx["seqs1"], ctx["mats1"]
        bandwidth = ctx["bandwidth"]
        dev_jobs = []
        dev_spec = []
        stale0 = _remsa_stale_start(pad)
        carry3 = np.zeros(pad - stale0, np.uint8)
        for rid in range(self.nseq):
            rdlen = self.rdlen(rid)
            if rdlen == 0:
                continue
            if rid >= nseq:
                if not all_:
                    break
                qb, qe = self._remsa_map_noncore(rid, rdlen, mlen)
            else:
                qb, qe = 0, rdlen
            s0 = np.full(pad, 4, np.uint8)
            m0 = np.zeros((4, pad), np.uint8)
            # roll the reference's uncleared T-plane tail (bspoa.h:4348)
            # through the per-read jobs so each job's counts match the
            # host loop byte-for-byte (see _remsa_stale_start)
            m0[3, stale0:] = carry3
            self._remsa_fill_read(rid, qb, qe, s0, m0, HW)
            carry3 = m0[3, stale0:].copy()
            mbeg = g.nodes[g.rdnode(rid, qb)].mpos
            mend = g.nodes[g.rdnode(rid, qe - 1)].mpos + 1
            dev_jobs.append(PeditJob(s0, seqs1, m0, mats1, mlen, mbeg,
                                     mend, bandwidth, HW))
            dev_spec.append((rid, rdlen, qb, qe, mbeg, mend, s0, m0))
        return dev_jobs, dev_spec

    def _remsa_dev_apply(self, ctx, dev_spec, dev_mats, all_):
        """Order-sensitive graph surgery from the jobs' forward matrices:
        cut, traceback (which merges read nodes into the rails) and
        reconnect, read by read in order."""
        g = self.g
        mlen, HW, rowlen = ctx["mlen"], ctx["HW"], ctx["rowlen"]
        seqs1, mats1 = ctx["seqs1"], ctx["mats1"]
        for spec, (mx0, mx1) in zip(dev_spec, dev_mats):
            rid, rdlen, qb, qe, mbeg, mend, s0, m0 = spec
            NR.g_cut_range(g, rid, qb, qe, 3)
            ndoffs_arr = np.asarray(g.ndoffs, np.int64)
            NR.pedit_traceback(
                g, mx0, mx1, s0, seqs1, m0, mats1, ndoffs_arr, mlen,
                mbeg, mend, HW, rowlen, rid, self.nseq + 1, qe)
            NR.g_connect_range(g, rid, 0, rdlen)
        self.del_msanodes()
        if all_:
            self.nrds = self.nseq

    def _remsa_map_noncore(self, rid, rdlen, mlen):
        """Map a non-core read onto the finished core MSA via (kmer-)edit
        vs the consensus (bspoa.h:4351-4427); sets per-node mpos and
        returns the [qb, qe) aligned range."""
        g = self.g
        self.qlen = self.slen = rdlen
        self.qb = 0
        self.qe = rdlen
        qseq = self.seqs[rid]
        if self.par.ksz:
            rs, cg = OE.kmer_edit_pairwise(self.par.ksz, qseq, self.cns)
        else:
            rs, cg = OE.edit_pairwise(qseq, self.cns, self.par.alnmode, 0)
        self.qb, self.qe = rs.qb, rs.qe
        self.slen = self.qe - self.qb
        for i in range(rdlen):
            g.nodes[g.rdnode(rid, i)].mpos = 0
        x, y = rs.qb, rs.tb
        from ..cigar import iter_cigar_ops
        for op in iter_cigar_ops(cg):
            if op in (0, 7, 8):
                u = g.nodes[g.rdnode(self.nseq, y)]
                g.nodes[g.rdnode(rid, x)].mpos = u.mpos
                x += 1
                y += 1
            elif op in (1, 4):
                x += 1
            else:
                y += 1
        # revise leading (bspoa.h:4399-4427)
        y = -1
        x = rs.qb
        while x < rs.qe:
            v = g.nodes[g.rdnode(rid, x)]
            if v.mpos:
                y = v.mpos
                break
            x += 1
        z = x
        while z >= rs.qb:
            v = g.nodes[g.rdnode(rid, z)]
            if y + z - x < 0:
                break
            v.mpos = y + z - x
            z -= 1
        z += 1
        qb = z
        while x < rs.qe:
            v = g.nodes[g.rdnode(rid, x)]
            if v.mpos == 0:
                v.mpos = y
                y += 1
            elif v.mpos < y:
                v.mpos = y
                y += 1
            else:
                y = v.mpos + 1
            if y >= mlen:
                break
            x += 1
        qe = x
        return qb, qe

    def _remsa_fill_read(self, rid, qb, qe, seqs0, mats0, HW):
        """Fill the read-side base string + homopolymer-rank counts from
        the node arrays (reads mpos/base only — safe before cutting)."""
        g = self.g
        from .graph import ND_BASE, ND_MPOS
        base0 = g.ndoffs[rid]
        mps = g._nd[ND_MPOS][base0 + qb: base0 + qe].astype(np.int64)
        bss = g._nd[ND_BASE][base0 + qb: base0 + qe].astype(np.int64)
        n = qe - qb
        if n:
            seqs0[HW + mps] = bss
            # homopolymer rank counted from the run END (the scalar
            # loop walks k descending; the run's last base stores
            # nothing), capped at 255
            idx = np.arange(n)
            is_end = np.empty(n, bool)
            is_end[-1] = True
            is_end[:-1] = bss[:-1] != bss[1:]
            ends_rev = np.where(is_end[::-1], idx[::-1], n)
            run_end = np.minimum.accumulate(ends_rev)[::-1]
            val = np.minimum(run_end - idx, 255)
            mask = run_end != idx
            mats0[bss[mask], HW + mps[mask]] = val[mask]

    # ------------------------------------------------------- tidy + SNV
    def _top2_all(self, nseq, calc_n):
        """Per-column base counts and top-2 bases for every MSA column at
        once (vectorized form of the reference's per-column scan in
        call_snvs/tidy, bspoa.h:4834-5049, exact tie-break order).

        Returns (bcnts [mlen, 6], m1 [mlen], m2 [mlen])."""
        idxs = np.asarray(self.msaidxs, np.int64)
        cols = self.msacols[idxs][:, :nseq]
        mlen = len(idxs)
        bcnts = np.zeros((mlen, 6), np.int64)
        for b in range(5):
            bcnts[:, b] = np.count_nonzero(cols == b, axis=1)
        bcnts[:, 5] = bcnts[:, :5].sum(axis=1)
        m1 = np.where(bcnts[:, 0] >= bcnts[:, 1], 0, 1)
        m2 = 1 - m1
        rows = np.arange(mlen)
        for i in range(2, 5 if calc_n else 4):
            bi = bcnts[:, i]
            gt1 = bi > bcnts[rows, m1]
            gt2 = (~gt1) & (bi > bcnts[rows, m2])
            m2 = np.where(gt1, m1, np.where(gt2, i, m2))
            m1 = np.where(gt1, i, m1)
        return bcnts, m1, m2

    def tidy_msa(self):
        """Tenon-mortise gap fix + re-consensus (bspoa.h:4834-4929)."""
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        lst = 0
        lc = 4
        lq = 0
        lpos = None
        idxs = np.asarray(self.msaidxs, np.int64)
        qlt_all = self.msacols[idxs][:, nall + 2].astype(np.int64)
        bc_all, m1_all, m2_all = self._top2_all(nseq, 1)
        # precomputed per-column stats stay valid: the tenon-mortise fix
        # only mutates columns at or before the current position
        for pos in np.flatnonzero(qlt_all >= self.par.althi).tolist():
            col = self.msacols[self.msaidxs[pos]]
            qlt = int(qlt_all[pos])
            bcnts = bc_all[pos]
            m1 = int(m1_all[pos])
            m2 = int(m2_all[pos])
            alt = 4
            gap = 0
            if m1 == 4 and bcnts[m2]:
                gap = bcnts[m1]
                alt = m2
            elif m2 == 4 and bcnts[m1]:
                alt = m1
                gap = bcnts[m2]
            if alt == 4 or gap < int(0.1 * bcnts[5]) \
                    or bcnts[alt] < int(0.1 * bcnts[5]):
                continue
            if lpos is None:
                pass
            elif alt == lc:
                if qlt < lq:
                    continue
            elif lst >= int(0.75 * bcnts[alt]):
                e = lpos
                while e < pos:
                    bss = self.msacols[self.msaidxs[e + 1]]
                    if bss[nall] < 4 and bss[nall] != lc:
                        break
                    e += 1
                f = pos
                while f > e:
                    bss = self.msacols[self.msaidxs[f - 1]]
                    if bss[nall] < 4 and bss[nall] != alt:
                        break
                    f -= 1
                if e + 1 >= f:
                    bss = self.msacols[self.msaidxs[lpos]]
                    e2 = f2 = 0
                    for rid in range(nseq):
                        if col[rid] < 4 and bss[rid] < 4 \
                                and col[rid] != bss[rid]:
                            e2 += 1
                        elif col[rid] < 4 or bss[rid] < 4:
                            f2 += 1
                    if f2 >= int(0.75 * bcnts[5]) \
                            and e2 <= int(0.40 * min(gap, lst)):
                        for rid in range(nseq):
                            if col[rid] == alt and bss[rid] == 4:
                                bss[rid] = alt
                                col[rid] = 4
                        lpos = None
                        lst = 0
                        lc = 4
                        lq = 0
                        continue
            lpos = pos
            lst = gap
            lc = alt
            lq = qlt
        self.cns_call()

    def call_snvs(self):
        """Sequencing-error-rate estimate + per-column SNV test
        (bspoa.h:4931-5049)."""
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        realnseq = nseq if (nseq and self.nseq and self.rdlen(0)) else nseq - 1
        mlen = len(self.msaidxs)
        pinc = 0.0005
        pcnt = 100
        pmin = 0.01
        acnt = realnseq * (realnseq // 2 + 1)
        psums = np.zeros(pcnt, np.float32)
        acnts = np.zeros(acnt, np.int64)
        mincov = max(2, int(np.float32(realnseq * np.float32(self.par.min_covfrq))))
        bc_all, m1_all, m2_all = self._top2_all(nseq, 0)
        rows_ix = np.arange(len(bc_all))
        bm1 = bc_all[rows_ix, m1_all]
        bm2 = bc_all[rows_ix, m2_all]
        covs = bc_all[:, 5]
        sel = bm1 + bm2 >= mincov
        keys = bm2[sel] * realnseq + covs[sel] - 1
        np.add.at(acnts, keys[keys < acnt], 1)
        for i in range(1, acnt):
            if acnts[i] == 0:
                continue
            altn = i // realnseq
            covn = (i % realnseq) + 1
            pexp = 1.0 * altn / covn
            j = int(pexp / pinc)
            if 0 < j < pcnt:
                for k in range(j):
                    perr = pexp - pinc * k
                    prob = math.exp(cal_binomial(covn, altn, perr))
                    psums[j - k] = np.float32(
                        np.float64(psums[j - k]) + float(acnts[i]) * prob)
                    if prob <= pmin:
                        break
                k = 1
                while j + k < pcnt:
                    perr = pexp + pinc * k
                    prob = math.exp(cal_binomial(covn, altn, perr))
                    psums[j + k] = np.float32(
                        np.float64(psums[j + k]) + float(acnts[i]) * prob)
                    if prob <= pmin:
                        break
                    k += 1
        perr = 1.0
        pexp = 0.01
        for i in range(pcnt):
            if perr < float(psums[i]):
                pexp = i * pinc
                perr = float(psums[i])
        self.var = []
        idxs = np.asarray(self.msaidxs, np.int64)
        cns_row = self.msacols[idxs][:, nall]
        nongap = cns_row < 4
        lpos_all = np.cumsum(nongap) - nongap  # exclusive prefix count
        cand = ((m1_all < 4) & (m2_all < 4)
                & (bm2 >= self.par.min_varcnt) & sel)
        for pos in np.flatnonzero(cand).tolist():
            covn, altn = int(covs[pos]), int(bm2[pos])
            prob = cal_binomial(covn, altn, pexp)
            qual = int(-(prob / math.log(10)))
            if qual > 1000:
                qual = 1000
            if qual >= self.par.min_snvqlt:
                self.var.append(dict(cpos=int(lpos_all[pos]), mpos=pos,
                                     covn=covn, refn=int(bm1[pos]),
                                     refb=int(m1_all[pos]), altn=altn,
                                     altb=int(m2_all[pos]), qual=qual))

    # ------------------------------------------------------------- driver
    def end_begin(self) -> bool:
        """end_bspoa up to the realignment loop (bspoa.h:4722-4760):
        shuffle, node chains, incremental graph alignment. Returns False
        when there is nothing to align (the caller skips the rest)."""
        self.cns = np.zeros(0, np.uint8)
        self.qlt = np.zeros(0, np.uint8)
        self.alt = np.zeros(0, np.uint8)
        if self.par.refmode:
            self.cns = self.seqs[0].copy()
            self.qlt = np.zeros(len(self.cns), np.uint8)
            self.alt = np.zeros(len(self.cns), np.uint8)
        if self.nseq <= 1:
            return False
        if self.par.shuffle:
            self.shuffle_reads_by_kmers()
        if self.par.seqcore:
            self.nmsa = min(self.nseq, self.par.seqcore)
        else:
            self.nmsa = self.nseq
        for rid in range(self.nseq):
            self._add_read_core(rid)
        self.nrds = 1
        if not self.par.refmode and self.nmsa > 1:
            self._end_begin_native()
            return True
        for rid in range(1, self.nmsa):
            if not self.par.refmode and self.par.bwtrigger:
                self.msa()
                self.simple_cns()
            self.align_rd(self.par, 0, rid, 0, self.rdlen(rid))
            self.nrds += 1
        return True

    def _end_begin_native(self):
        """end_begin's incremental loop in one resumable native call
        (bsa_end_begin_loop, rowops.cpp): per read, the running
        msa/simple_cns recompute plus the align mega-call — replacing two
        ctypes round-trips and the per-read msacols/msaidxs rebuild."""
        g = self.g
        par = self.par
        nseq = self.nseq
        rdlens = np.fromiter((self.rdlen(r) for r in range(nseq)), np.int64,
                             nseq)
        seqoffs = np.zeros(nseq + 1, np.int64)
        np.cumsum(rdlens, out=seqoffs[1:])
        seqcat = np.ascontiguousarray(
            np.concatenate([np.asarray(self.seqs[r], np.uint8)
                            for r in range(nseq)])
            if int(seqoffs[-1]) else np.zeros(1, np.uint8))
        ndoffs_arr = np.asarray(g.ndoffs, np.int64)
        mrow = nseq + 3
        # mlen is bounded by the longest graph path <= inserted bases + 2;
        # start from the aligned total and regrow on the flag-2 signal
        mcap = int(rdlens[:self.nmsa].sum()) + 64
        msab = np.empty(mcap * mrow, np.uint8)
        cnsb = np.empty(mcap, np.uint8)
        stack_buf = np.empty(len(g.nodes) + 16, np.int32)
        out = np.zeros(3, np.int64)
        maxrlen = int(rdlens.max()) if nseq else 0
        rid = 1
        while rid < self.nmsa:
            # headroom for at least one read: the C loop checks the same
            # bound per read and returns early instead of reallocating
            g._encap_edges(4 * len(g.nodes) + 24 * (maxrlen + 4) + 4096)
            r = NR.end_begin_loop(g, seqcat, seqoffs, rdlens, ndoffs_arr,
                                  par, self.nmsa, nseq, rid, msab, mrow,
                                  cnsb, stack_buf, out)
            self.nrds = min(r, self.nmsa)
            if r >= self.nmsa:
                break
            flag = int(out[2])
            if flag == 2:                   # msa buffers too small
                need = (int(out[0]) + 16) * mrow
                msab = np.empty(max(need, 2 * len(msab)), np.uint8)
                cnsb = np.empty(max(int(out[0]) + 16, 2 * len(cnsb)),
                                np.uint8)
                rid = r
                continue
            if flag == 1:                   # read r needs the Python path
                if par.bwtrigger:
                    self._msa_state_from_native(out, msab, cnsb, mrow)
                self.align_rd(par, 0, r, 0, int(rdlens[r]))
                self.nrds = r + 1
                rid = r + 1
                continue
            rid = r                         # flag 0: edge headroom, retry
        if par.bwtrigger:
            self._msa_state_from_native(out, msab, cnsb, mrow)

    def _msa_state_from_native(self, out, msab, cnsb, mrow):
        """Rebuild msaidxs/msacols/cns/qlt/alt exactly as the last
        msa()+simple_cns() pair of the Python loop would leave them."""
        mlen, clen = int(out[0]), int(out[1])
        self.msaidxs = list(range(mlen))
        self.msacols = msab[:mlen * mrow].reshape(mlen, mrow).copy()
        self.cns = cnsb[:clen].copy()
        self.qlt = np.zeros(clen, np.uint8)
        self.alt = np.zeros(clen, np.uint8)

    def end_realn_round(self, i: int) -> None:
        """One realignment round of end_bspoa (bspoa.h:4762-4772)."""
        self.msa()
        self.cns_call()
        if self.par.editbw < 0:
            self.remsa_edits(-self.par.editbw)
        else:
            self.remsa_pedits(self.par.editbw // 2, 1,
                              1 if (i + 1 == self.par.realn) else 0)

    def end_finish(self) -> None:
        """end_bspoa tail (bspoa.h:4773-4776)."""
        if self.par.shuffle:
            self.restore_rd_orders()
        self.msa()
        self.cns_call()

    def end(self):
        if not self.end_begin():
            return
        for i in range(self.par.realn):
            self.end_realn_round(i)
        self.end_finish()

    def remsa_edits(self, W: int):
        """Scalar banded edit realignment vs the column profile
        (bspoa.h:4459-4721); used when editbw < 0."""
        g = self.g
        nseq = self.nrds
        nall = nseq if self.nseq == 0 else self.nseq
        mlen = len(self.msaidxs)
        W = (W + 1) & ~1
        HW = W >> 1
        if mlen < W:
            return
        self.add_msanodes()
        SMIN = -(0xFFFFFFFF >> 2)
        bcnts = np.zeros((mlen, 5), np.int64)
        seqs1 = np.full(mlen + 2 * HW, 4, np.uint8)
        order = np.asarray(self.msaidxs, np.int64)
        mat = self.msacols[order]
        seqs1[HW:HW + mlen] = mat[:, nall]
        sub = mat[:, :nall]
        for b in range(4):
            bcnts[:, b] = (sub == b).sum(axis=1)

        cnt = np.ascontiguousarray(bcnts[:, :4])
        NR.hp_adjust(mlen, np.ascontiguousarray(seqs1[HW:HW + mlen]), cnt,
                     False)
        bcnts[:, :4] = cnt
        matrix = np.zeros(mlen * W, np.uint8)
        seqs0 = np.full(mlen + 2 * HW, 4, np.uint8)
        breps = np.zeros(mlen, np.int64)
        for rid in range(nseq):
            rdlen = self.rdlen(rid)
            if rdlen == 0:
                continue
            seqs0[HW:HW + mlen] = 4
            breps[:] = 0
            lc = 4
            cc = 0
            for i in range(rdlen, 0, -1):
                vi = g.cut_rdnode(rid, i - 1, 3)
                v = g.nodes[vi]
                seqs0[HW + v.mpos] = v.base
                if v.base == lc:
                    if cc < 0xF:
                        cc += 1
                    breps[v.mpos] = cc << (v.base << 2)
                else:
                    lc = v.base
                    cc = 0
            mbeg = g.nodes[g.rdnode(rid, 0)].mpos
            mend = g.nodes[g.rdnode(rid, rdlen - 1)].mpos + 1
            # forward DP (bspoa.h:4471-4497)
            lst = np.full(W + 1, SMIN, np.int64)
            lst[HW:W] = 0
            cur = np.full(W + 1, SMIN, np.int64)
            for y in range(mbeg, mend):
                cb = int(seqs1[HW + y]) << 2
                s = SMIN
                mtx_row = matrix[y * W:(y + 1) * W]
                for x in range(W):
                    xi = y + x - HW
                    bt = 1  # I
                    lb = int(seqs0[HW + xi])
                    rep = (int(breps[xi]) >> cb) & 0xF \
                        if 0 <= xi < mlen else 0
                    bsv = int(bcnts[y, lb]) if lb < 4 else 0
                    h = int(lst[x]) + bsv + rep
                    e = int(lst[x + 1])
                    if s < h:
                        s = h
                        bt = 0  # M
                    if s < e:
                        s = e
                        bt = 2  # D
                    cur[x] = s
                    mtx_row[x] = bt
                lst, cur = cur, lst
            # traceback (bspoa.h:4498-4534)
            y = mend - 1
            x = mend - 1
            roff = rdlen
            while True:
                xi = x - y + HW
                bt = int(matrix[y * W + xi])
                if bt == 0:
                    if seqs0[HW + x] < 4:
                        roff -= 1
                        # bspoa.h:4514 indexes rails WITHOUT the +1 used by
                        # remsa_pedits (bspoa.h:4016): base A merges into
                        # the cns-read chain and base b into rail b-1. This
                        # IS reachable from the reference CLI — the POSIX
                        # ERE `([.0-9]+?)` parses as an OPTIONAL group, so
                        # "editbw=-64" matches with an empty value and
                        # atoi(main.c:462) then reads "-64" past the match.
                        # Byte parity requires replicating the off-by-one.
                        u = g.rdnode(self.nseq + int(seqs0[HW + x]), y)
                        v = g.rdnode(rid, roff)
                        g.merge_nodes(u, v)
                    x -= 1
                    y -= 1
                elif bt == 1:
                    if seqs0[HW + x] < 4:
                        roff -= 1
                    x -= 1
                else:
                    y -= 1
                if x < mbeg or y < mbeg:
                    break
            NR.g_connect_range(g, rid, 0, rdlen)
        self.del_msanodes()

    # ------------------------------------------------------------ printing
    def print_msa(self, label: str, out, linewidth: int = 0, colorful: int = 0):
        nseq = self.nseq
        mrow = nseq + 3
        mlen = len(self.msaidxs)
        mbeg, mend = 0, mlen
        if linewidth == 0 or linewidth > mend - mbeg:
            linewidth = mend - mbeg
        roffs = [0] * (nseq + 1)
        beg = mbeg
        while beg < mend:
            end = min(mend, beg + linewidth)
            out.write(f"{label} MSA [POS] "
                      f"{self._str_msa_ruler(beg, end)}\n")
            cbeg = roffs[nseq]
            for i in range(mrow):
                out.write(f"{label} MSA ")
                if i <= nseq:
                    s, rend = self._str_msa_seq(beg, end, i, roffs[i],
                                                colorful)
                    tagl = "[CNS] " if i == nseq else f"[{i:03d}] "
                    out.write(tagl + f"{s} {roffs[i]}\t{rend}\n")
                    roffs[i] = rend
                else:
                    s = self._str_msa_qlt(beg, end, i, colorful)
                    out.write(("[QLT] " if i == nseq + 1 else "[ALT] ")
                              + s + "\n")
            out.write(f"{label} MSA [POS] "
                      f"{self._str_cns_ruler(beg, end, cbeg)}\n")
            cn = roffs[nseq]
            seg = "".join("ACGTN-"[b] for b in self.cns[cbeg:cn])
            out.write(f"{label} CNS\t{cn - cbeg}\t{seg}\n")
            seg = "".join(chr(33 + int(b)) for b in self.qlt[cbeg:cn])
            out.write(f"{label} QLT\t{cn - cbeg}\t{seg}\n")
            seg = "".join(chr(33 + int(b)) for b in self.alt[cbeg:cn])
            out.write(f"{label} ALT\t{cn - cbeg}\t{seg}\n")
            beg = end

    def _str_msa_ruler(self, mbeg, mend):
        """bspoa.h:1360-1388: '|%05u' markers every 10 columns + '~' at SNVs."""
        s: List[str] = []
        j = mbeg
        for i in range(mbeg, mend):
            if (i % 10) == 0 and j + 6 <= mend:
                s.extend(f"|{i:05d}")
                j += 6
            elif i >= j:
                s.append(" ")
                j += 1
        for x in self.var:
            if x["mpos"] >= mend:
                break
            if x["mpos"] >= mbeg and x["mpos"] - mbeg < len(s):
                s[x["mpos"] - mbeg] = "~"
        return "".join(s)

    def _str_msa_seq(self, mbeg, mend, rid, rbeg, colorful=0):
        nseq = self.nseq
        g = self.g
        roff = rbeg
        chars = []
        if colorful:
            # bspoa.h:1400-1447: reverse-video on SNV columns, bold on
            # colorful (re-POA'd) nodes, red lowercase on mismatches
            def node_at(off):
                if g.nodes and rid < nseq:
                    return g.nodes[g.rdnode(rid, off)]
                return None
            v = node_at(roff)
            ci = 0
            while ci < len(self.var) and self.var[ci]["mpos"] < mbeg:
                ci += 1
            x = self.var[ci] if ci < len(self.var) else None
            for i in range(mbeg, mend):
                col = self.msacols[self.msaidxs[i]]
                if x is not None and x["mpos"] == i:
                    chars.append("\x1b[7m")
                    ci += 1
                    x = self.var[ci] if ci < len(self.var) else None
                elif v is not None and v.colorful:
                    chars.append("\x1b[1m")
                if col[rid] <= 4 and col[rid] != col[nseq]:
                    chars.append("\x1b[31m")
                    chars.append("acgt-.*"[col[rid]])
                else:
                    chars.append("ACGT-.*"[col[rid]])
                chars.append("\x1b[0m")
                if col[rid] < 4:
                    roff += 1
                    v = node_at(roff)
            return "".join(chars), roff
        for i in range(mbeg, mend):
            col = self.msacols[self.msaidxs[i]]
            if col[rid] <= 4 and col[rid] != col[nseq]:
                ch = "acgt-.*"[col[rid]]
            else:
                ch = "ACGT-.*"[col[rid]]
            chars.append(ch)
            if col[rid] < 4:
                roff += 1
        return "".join(chars), roff

    def _str_msa_qlt(self, mbeg, mend, row, colorful=0):
        chars = []
        for i in range(mbeg, mend):
            col = self.msacols[self.msaidxs[i]]
            ch = chr(33 + int(col[row]))
            if colorful:
                # bspoa.h:1459-1471: green below althi, red below qlthi,
                # and a reset after every char (even uncolored ones)
                if col[row] < self.par.althi:
                    chars.append("\x1b[32m")
                elif col[row] < self.par.qlthi:
                    chars.append("\x1b[31m")
                chars.append(ch)
                chars.append("\x1b[0m")
            else:
                chars.append(ch)
        return "".join(chars)

    def _str_cns_ruler(self, mbeg, mend, cbeg):
        nseq = self.nseq
        out = []
        j = cbeg
        b = mbeg
        i = mbeg
        while i < mend:
            if self.msacols[self.msaidxs[i]][nseq] < 4:
                if (j % 10) == 0:
                    while b < i:
                        out.append(" ")
                        b += 1
                    if b + 6 < mend:
                        out.append(f"|{j:05d}")
                        b += 6
                j += 1
            i += 1
        while b < mend:
            out.append(" ")
            b += 1
        return "".join(out)

    def print_snvs(self, label: str, out):
        nseq = self.nrds
        fsz = 5
        for var in self.var:
            cpos = var["cpos"]
            fct = min(cpos, fsz)
            fl0 = "".join("ACGTN-"[b] for b in self.cns[cpos - fct:cpos])
            fq0 = "".join(chr(33 + int(b)) for b in self.qlt[cpos - fct:cpos])
            fct2 = min(len(self.cns) - cpos - 1, fsz)
            fl1 = "".join("ACGTN-"[b]
                          for b in self.cns[cpos + 1:cpos + 1 + fct2])
            fq1 = "".join(chr(33 + int(b))
                          for b in self.qlt[cpos + 1:cpos + 1 + fct2])
            col = self.msacols[self.msaidxs[var["mpos"]]]
            gts = "".join("ACGT-.*"[int(col[r])] for r in range(nseq))
            out.write(f"{label} SNP\t{cpos}\t{var['mpos']}\t{fl0}\t{fq0}\t"
                      f"{'ACGTN-'[var['refb']]}\t{var['refn']}\t"
                      f"{'ACGTN-'[var['altb']]}\t{var['altn']}\t{fl1}\t{fq1}\t"
                      f"{var['covn']}\t{var['qual']}\t{gts}\n")

    # ----------------------------------------------------- binary MSA I/O
    def dump_binary_msa(self, out, metadat: bytes = b""):
        """Tagged records 0x81 meta | 0x22 cols+qlt+alt | 0xFF (bspoa.h:1555)."""
        import struct
        nseq = self.nrds
        mlen = len(self.msaidxs)
        if metadat:
            out.write(b"\x81" + struct.pack("<I", len(metadat)) + metadat)
        out.write(b"\x22" + struct.pack("<II", mlen, nseq))
        qlts = bytearray()
        alts = bytearray()
        for i in range(mlen):
            col = self.msacols[self.msaidxs[i]]
            out.write(bytes(col[: nseq + 1]))
            qlts.append(int(col[nseq + 1]))
            alts.append(int(col[nseq + 2]))
        out.write(bytes(qlts))
        out.write(bytes(alts))
        out.write(b"\xFF")

    def load_binary_msa(self, inp) -> int:
        """bspoa.h:1586-1685; returns 0 on success."""
        import struct
        self._reset()
        while True:
            tag = inp.read(1)
            if not tag:
                return -1  # EOF
            if tag == b"\xFF":
                self._post_load_binary()
                return 0
            if tag == b"\x81":
                (dlen,) = struct.unpack("<I", inp.read(4))
                self.mtag = inp.read(dlen)
            elif tag == b"\x22":
                dcnt, dlen = struct.unpack("<II", inp.read(8))
                nseq = dlen
                self.nrds = self.nmsa = nseq
                mrow = nseq + 3
                self.msaidxs = list(range(dcnt))
                self.msacols = np.full((dcnt, mrow), 4, np.uint8)
                for i in range(dcnt):
                    self.msacols[i, : nseq + 1] = np.frombuffer(
                        inp.read(nseq + 1), np.uint8)
                qa = np.frombuffer(inp.read(dcnt * 2), np.uint8)
                self.msacols[:, nseq + 1] = qa[:dcnt]
                self.msacols[:, nseq + 2] = qa[dcnt:]

    def _post_load_binary(self):
        nseq = self.nrds
        mrow = nseq + 3
        dcnt = len(self.msaidxs)
        self.seqs = []
        self.cigars = [[] for _ in range(nseq)]
        for i in range(nseq):
            bases = [int(self.msacols[self.msaidxs[j], i]) for j in range(dcnt)
                     if self.msacols[self.msaidxs[j], i] < 4]
            self.seqs.append(np.array(bases, np.uint8))
        cns, qlt, alt = [], [], []
        for i in range(dcnt):
            col = self.msacols[self.msaidxs[i]]
            if col[nseq] < 4:
                cns.append(int(col[nseq]))
                qlt.append(int(col[nseq + 1]))
                alt.append(int(col[nseq + 2]))
        self.cns = np.array(cns, np.uint8)
        self.qlt = np.array(qlt, np.uint8)
        self.alt = np.array(alt, np.uint8)
