"""CIGAR utilities (port of bsalign_tpu.cigar).

Packed-cigar convention matches SAM and the reference ((len<<4)|op,
bsalign.h:401-417); alignment-string rendering mirrors
seqalign_cigar2alnstr (bsalign.h:531-582) and left-justified indel tidying
mirrors seqalign_left_tidy_cigars (bsalign.h:439-529).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .constants import CIGAR_CHARS
from .seqs import BIT_BASE


@dataclass
class AlnResult:
    """Mirror of seqalign_result_t (bsalign.h:213-218)."""

    score: int = 0
    qb: int = 0
    qe: int = 0
    tb: int = 0
    te: int = 0
    mat: int = 0
    mis: int = 0
    ins: int = 0
    dele: int = 0
    aln: int = 0


def push_cigar(cigars: List[int], op: int, sz: int) -> None:
    """Append run-length op, merging with the tail run (bsalign.h:401-407)."""
    if cigars and (cigars[-1] & 0xF) == op:
        cigars[-1] += sz << 4
    else:
        cigars.append((sz << 4) | op)


def cigars_to_str(cigars: List[int]) -> str:
    out = []
    for cg in cigars:
        out.append(f"{cg >> 4}{CIGAR_CHARS[cg & 0xF]}")
    return "".join(out)


def iter_cigar_ops(cigars: List[int]):
    """Each op of the packed CIGAR, once per base it covers."""
    for cg in cigars:
        op = cg & 0xF
        for _ in range(cg >> 4):
            yield op


def cigar2alnstr(qseq: np.ndarray, tseq: np.ndarray, rs: AlnResult,
                 cigars: List[int], length: int = 0) -> Tuple[str, str, str]:
    """Render (query_line, match_line, target_line); bsalign.h:531-582."""
    if length == 0:
        length = rs.aln
    q, m, t = [], [], []
    x, y, z = rs.qb, rs.tb, 0
    for cg in cigars:
        op = cg & 0xF
        sz = min(cg >> 4, length - z)
        if op in (0, 7, 8):
            for _ in range(sz):
                m.append("|" if qseq[x] == tseq[y] else "*")
                q.append(BIT_BASE[qseq[x]])
                t.append(BIT_BASE[tseq[y]])
                x += 1
                y += 1
                z += 1
        elif op in (1, 4):
            for _ in range(sz):
                m.append("-")
                q.append(BIT_BASE[qseq[x]])
                t.append("-")
                x += 1
                z += 1
        elif op in (2, 3):
            for _ in range(sz):
                m.append("-")
                q.append("-")
                t.append(BIT_BASE[tseq[y]])
                y += 1
                z += 1
        if z == length:
            break
    return "".join(q), "".join(m), "".join(t)


def left_tidy_cigars(qseq: np.ndarray, tseq: np.ndarray, rs: AlnResult,
                     cigars: List[int]) -> Tuple[int, List[int]]:
    """Left-justify indels within a 64-column sliding window, reproducing
    seqalign_left_tidy_cigars (bsalign.h:439-529). Returns (n_moves, cigars).
    """
    L = 64
    alns = [[0] * L, [0] * L]
    seqs = (qseq, tseq)
    xpos = [rs.qb, rs.tb]
    out: List[int] = []
    moved = 0
    p = 0
    z = 0

    def emit(op: int) -> None:
        if out and (out[-1] & 0xF) == op:
            out[-1] += 1 << 4
        else:
            out.append((1 << 4) | op)

    def pop_one() -> None:
        nonlocal p, z, moved
        q = -1
        if alns[0][p] == 5:
            q = 2 if alns[1][p] == 5 else 0
        elif alns[1][p] == 5:
            q = 1
        if q in (0, 1):
            for i in range(1, z):
                j = (p + i) % L
                if alns[q][j] == alns[1 - q][p]:
                    alns[q][p] = alns[1 - q][p]
                    alns[q][j] = 5
                    moved += 1
                    break
                if alns[q][j] != 5:
                    break
        if alns[0][p] == 5:
            emit(2)  # D
        elif alns[1][p] == 5:
            emit(1)  # I
        else:
            emit(0)  # M
        p = (p + 1) % L
        z -= 1

    for op in iter_cigar_ops(cigars):
        if op in (0, 7, 8):
            flags = 3
        elif op in (1, 4):
            flags = 1
        else:
            flags = 2
        if z == L:
            pop_one()
        q = (p + z) % L
        z += 1
        for i in range(2):
            if flags & (1 << i):
                alns[i][q] = int(seqs[i][xpos[i]])
                xpos[i] += 1
            else:
                alns[i][q] = 5
    while z:
        pop_one()
    return moved, out


def cigar_stats(qseq: np.ndarray, tseq: np.ndarray, qb: int, tb: int,
                cigars: List[int]) -> AlnResult:
    """Recompute mat/mis/ins/del/aln/qe/te from a cigar run list."""
    rs = AlnResult(qb=qb, tb=tb)
    x, y = qb, tb
    for cg in cigars:
        op = cg & 0xF
        sz = cg >> 4
        if op in (0, 7, 8):
            eq = int(np.sum(qseq[x : x + sz] == tseq[y : y + sz]))
            rs.mat += eq
            rs.mis += sz - eq
            x += sz
            y += sz
        elif op in (1, 4):
            rs.ins += sz
            x += sz
        else:
            rs.dele += sz
            y += sz
        rs.aln += sz
    rs.qe = x
    rs.te = y
    return rs
