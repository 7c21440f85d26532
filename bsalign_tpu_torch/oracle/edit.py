"""Host helpers of the bit-parallel edit-distance aligner that the `edit`
driver and the POA engine call (port of the parts of bsalign_tpu.oracle.edit
they need).

The reference is striped_seqedit_* (bsalign.h:612-1206) and
kmer_striped_seqedit_pairwise (bsalign.h:1209-1536): per-pair band
selection, the traceback with its tie-break priority, and the unique-kmer
chain that splits a pair into segments.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..cigar import AlnResult
from ..constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP, mode_type, roundup
from .banded8 import c_div

MAX_B4 = 0x7FFFFFFF


def _select_bandwidth(qlen: int, tlen: int, mode: int, bandwidth: int) -> int:
    """bsalign.h:1055-1067."""
    if mode_type(mode) in (MODE_OVERLAP, MODE_EXTEND):
        return roundup(qlen, 64)
    bandwidth = roundup(bandwidth, 64)
    if bandwidth == 0 or bandwidth > qlen:
        bandwidth = roundup(qlen, 64)
    if bandwidth < qlen:
        if bandwidth < ((qlen + tlen - 1) // tlen) + 1:
            bandwidth = roundup((qlen + tlen - 1) // tlen + 1, 64)
    return bandwidth


def edit_backtrace(uts: np.ndarray, begs: List[int], qseq: np.ndarray,
                   x: int, tseq: np.ndarray, y: int, mode: int,
                   ) -> Tuple[AlnResult, List[int]]:
    """bsalign.h:965-1044. uts[i+1] = u-row after target base i; uts[0] = init.
    Priority: match > I(u==+1) > D(u_prev==-1) > mismatch."""
    rs = AlnResult()
    rs.qe = x + 1
    rs.te = y + 1
    cigars: List[int] = []

    def push(op: int, sz: int = 1) -> None:
        if cigars and (cigars[-1] & 0xF) == op:
            cigars[-1] += sz << 4
        else:
            cigars.append((sz << 4) | op)

    while x >= 0 and y >= 0:
        if qseq[x] == tseq[y]:
            rs.mat += 1
            op = 0
            x -= 1
            y -= 1
        else:
            u_cur = int(uts[y + 1][x - begs[y + 1]])
            if u_cur == 1:
                rs.ins += 1
                op = 1
                x -= 1
            else:
                u_prev = int(uts[y][x - begs[y]])
                if u_prev == -1:
                    rs.dele += 1
                    op = 2
                    y -= 1
                else:
                    rs.mis += 1
                    op = 0
                    x -= 1
                    y -= 1
        push(op)
    rs.qb = x + 1
    rs.tb = y + 1
    if rs.qb:
        push(1, rs.qb)
        rs.ins += rs.qb
        rs.qb = 0
    if mode_type(mode) in (MODE_GLOBAL, MODE_EXTEND) and rs.tb:
        push(2, rs.tb)
        rs.dele += rs.tb
        rs.tb = 0
    rs.aln = rs.mat + rs.mis + rs.ins + rs.dele
    return rs, cigars[::-1]


def _kmer_chain(qseq: np.ndarray, tseq: np.ndarray, ksz: int,
                ) -> Optional[List[Tuple[int, int]]]:
    """Unique-kmer 1:1 matching + LIS chaining + outlier filtering
    (bsalign.h:1219-1434). Returns [(qoff, toff)] or None when coverage is
    too small to trust the chain."""
    qlen, tlen = len(qseq), len(tseq)
    cmin = int(min(qlen, tlen) * 0.05 + 1)
    cmin = min(cmin, 2 * ksz)

    def kmerize(seq: np.ndarray):
        # vectorized rolling fwd/rc kmers: values/dirs identical to the
        # scalar recurrence kf=((kf<<2)|b)&kmk, kr=(kr>>2)|(comp(b)<<sft)
        m = len(seq) - ksz + 1
        if m <= 0:
            z = np.zeros(0, np.int64)
            return z, z
        win = np.lib.stride_tricks.sliding_window_view(
            seq.astype(np.int64), ksz)
        wf = (4 ** np.arange(ksz - 1, -1, -1)).astype(np.int64)
        wr = (4 ** np.arange(ksz)).astype(np.int64)
        kf = win @ wf
        kr = (3 - win) @ wr
        dirn = kr < kf
        return np.where(dirn, kr, kf), dirn.astype(np.int64)

    vq, dq = kmerize(qseq)
    vt, dt = kmerize(tseq)
    vals = np.concatenate([vq, vt])
    dirs = np.concatenate([dq, dt])
    flgs = np.concatenate([np.zeros(len(vq), np.int64),
                           np.ones(len(vt), np.int64)])
    offs = np.concatenate([np.arange(len(vq), dtype=np.int64),
                           np.arange(len(vt), dtype=np.int64)])
    # stable sort by kmer value keeps q entries ahead of t entries on ties,
    # matching the reference's stable sort of the combined kmer list
    order = np.argsort(vals, kind="stable")
    v, d, f, o = vals[order], dirs[order], flgs[order], offs[order]
    n = len(v)
    # unique 1:1 pairs: kmer seen exactly twice, once per sequence, same dir
    if n >= 2:
        eq_next = np.zeros(n, bool)
        eq_next[:-1] = v[:-1] == v[1:]
        eq_prev = np.zeros(n, bool)
        eq_prev[1:] = eq_next[:-1]
        i0 = np.flatnonzero(eq_next & ~eq_prev)
        ok = (~eq_next[i0 + 1]) & (f[i0] != f[i0 + 1]) & (d[i0] == d[i0 + 1])
        i0 = i0[ok]
        qoffs, toffs = o[i0], o[i0 + 1]
    else:
        qoffs = toffs = np.zeros(0, np.int64)
    if len(qoffs) * ksz < cmin:
        return None
    order2 = np.argsort(qoffs, kind="stable")
    khits: List[Tuple[int, int]] = list(
        zip(qoffs[order2].tolist(), toffs[order2].tolist()))
    kcnt = len(khits)
    # LIS over target offsets, replicating the reference's exact linking rule
    # (bsalign.h:1285-1330, including its predecessor-of-predecessor link)
    lis0 = [0] * kcnt
    lis1 = [None] * kcnt
    xlen = 1
    for i in range(1, kcnt):
        t_i = khits[i][1]
        e = xlen - 1
        if t_i > khits[lis0[e]][1]:
            lis1[i] = lis0[e]
            lis0[xlen] = i
            xlen += 1
        elif t_i <= khits[lis0[0]][1]:
            lis1[i] = None
            lis0[0] = i
        else:
            lo, hi = 0, xlen
            while lo < hi:
                mid = lo + ((hi - lo) >> 1)
                if t_i > khits[lis0[mid]][1]:
                    lo = mid + 1
                elif t_i < khits[lis0[mid]][1]:
                    hi = mid
                else:
                    lo = mid
                    break
            lis1[i] = lis1[lis0[lo - 1]]
            lis0[lo] = i
    flags = [False] * kcnt
    cov = 0
    e = None
    m = lis0[xlen - 1]
    while m is not None:
        flags[m] = True
        toff = khits[m][1]
        if e is None or toff + ksz <= e:
            cov += ksz
        else:
            cov += e - toff
        e = toff
        m = lis1[m]
    if cov < cmin:
        return None
    # iterative mean/median outlier filter (bsalign.h:1346-1393)
    while True:
        deltas = [khits[i][0] - khits[i][1] for i in range(kcnt) if flags[i]]
        e = len(deltas)
        if e * ksz < cmin:
            break
        tot = sum(deltas)
        mean = c_div(tot, e)
        median = int(np.partition(np.asarray(deltas, dtype=np.int64),
                                  e // 2)[e // 2])
        var = abs(median - mean) * 3
        var = max(var, 50)
        removed = 0
        for i in range(kcnt):
            if not flags[i]:
                continue
            delta = khits[i][0] - khits[i][1]
            if abs(delta - mean) > var:
                flags[i] = False
                removed += 1
        if removed == 0:
            break
    chain = [khits[i] for i in range(kcnt) if flags[i]]
    # coverage over target offsets with overlap dedup (bsalign.h:1402-1415)
    m = 0
    e = 0
    for (_, toff) in chain:
        if toff >= e + ksz:
            m += ksz
        else:
            m += toff + ksz - e
        e = toff + ksz
    if m < cmin:
        return None
    return chain


def edit_pairwise(qseq: np.ndarray, tseq: np.ndarray, mode: int,
                  bandwidth: int) -> Tuple[AlnResult, List[int]]:
    """Scalar banded edit alignment of one pair (bsalign.h:1046-1206), in
    the host C++. The POA engine maps non-core reads onto the consensus
    with it."""
    if len(qseq) == 0 or len(tseq) == 0:
        return AlnResult(), []
    from ..native import rowops as NR
    return NR.edit_align(qseq, tseq, mode_type(mode), bandwidth)


def kmer_edit_pairwise(ksz: int, qseq: np.ndarray, tseq: np.ndarray,
                       ) -> Tuple[AlnResult, List[int]]:
    """Segmented edit alignment guided by unique-kmer synteny
    (bsalign.h:1209-1536), in the host C++."""
    from ..native import rowops as NR
    return NR.kmer_edit(min(ksz, 15), qseq, tseq)
