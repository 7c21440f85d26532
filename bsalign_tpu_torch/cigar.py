"""CIGAR utilities (port of the parts of bsalign_tpu.cigar that `align` and
`poa` use).

Packed-cigar convention matches SAM and the reference ((len<<4)|op,
bsalign.h:401-417); alignment-string rendering mirrors
seqalign_cigar2alnstr (bsalign.h:531-582).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

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
