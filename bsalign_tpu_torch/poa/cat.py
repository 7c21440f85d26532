"""`bsalign-tpu-torch cat` — concatenate sequence pieces by overlap
alignment (port of bsalign_tpu.poa.cat).

Mirrors main_cat (main.c:559-647) + cat_cns_seqs / revise_seq_joint_point
(bspoa.h:5567-5632): overlap-align tail(cns, W) x head(next, W), retry with
a 4x window on weak joins, snap the joint into the longest match run,
insert 6 N's when the join is untrustworthy.

Each join is one `align_batch` call of one pair in overlap mode at the band
the scalar oracle takes for bandwidth 0, roundup(qlen, 16): on a CUDA
device the banded-8 kernel, on the CPU its plain version. Joins run one
after another, since each join's query is the tail of the consensus built
so far. The band's width is the window's: the 4x retry of a window of
8,192 aligns at band 32,768, whose planes the kernel keeps in device
memory, in the two-pass mode of the driver.

N is kept as code 4. The JAX package's oracle refuses an N that it reaches
(an IndexError in its forward for an N in the target's window, in its
traceback for an N in the query at a base it scores: of an M op, the last
of an I op, the one before a D op); the port refuses the same joins with a
ValueError that names the piece: before the launch for the target side,
after the walk for the query side. An N inside an insertion run, away from
its last base, is consumed unscored by both; with a gap open of 0 (-O 0)
the oracle takes each inserted base as a run of its own and scores them
all, and so does the check.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from .. import seqs as S
from ..align.pairwise import align_batch
from ..cigar import AlnResult
from ..constants import MODE_OVERLAP, WORDSIZE, roundup
from ..oracle import banded8 as B8


def revise_seq_joint_point(cigars: List[int], qe: int, te: int
                           ) -> Tuple[int, int]:
    q = t = 0
    qq = tt = 0
    mx = 0
    for i in range(1, len(cigars) + 1):
        cg = cigars[len(cigars) - i]
        op = cg & 0xF
        ln = cg >> 4
        if op == 0:
            if ln > mx:
                qq, tt = q, t
                mx = ln
            q += ln
            t += ln
        elif op == 1:
            q += ln
        else:
            t += ln
    return qe - qq, te - tt


def _walked_query(rs: AlnResult, cigars: List[int],
                  gap_open: bool = True) -> List[int]:
    """Query positions the oracle's traceback scores against the target
    (bsalign_tpu/oracle/banded8.py backcal): every base an M op consumes,
    the base before each D op, and of each I op its last base (the
    traceback scores a run of insertions at the base it starts from, then
    consumes the run by the score identity) or, without a gap open cost,
    every base (the identity then holds for a run of one, so each base is
    a run of its own)."""
    out = []
    q = rs.qb
    for cg in cigars:
        op, ln = cg & 0xF, cg >> 4
        if op == 2:
            if q > 0:
                out.append(q - 1)
            continue
        if op == 1 and gap_open:
            out.append(q + ln - 1)
        else:
            out.extend(range(q, q + ln))
        q += ln
    return out


def _align(qseq: np.ndarray, tseq: np.ndarray, mtx, O: int, E: int, name,
           device) -> Tuple[AlnResult, List[int]]:
    """One overlap alignment of the join, refusing what the oracle
    refuses."""
    if int(np.max(tseq)) > 3:
        raise ValueError(f"cat: piece {name!r} has an N within the first "
                         f"{len(tseq)} bases that its join aligns")
    [(rs, cigars)] = align_batch([qseq], [tseq], MODE_OVERLAP,
                                 roundup(len(qseq), WORDSIZE), mtx, O, E, 0,
                                 0, device=device)
    if np.any(qseq[_walked_query(rs, cigars, O != 0)] > 3):
        raise ValueError(f"cat: the join of piece {name!r} aligns it "
                         "against an N of the sequence built so far")
    return rs, cigars


def cat_cns_seqs(seq1: np.ndarray, seq2: np.ndarray, overlap: int,
                 M: int, X: int, O: int, E: int, *, device, name="",
                 ) -> Tuple[AlnResult, List[int], int, int]:
    if len(seq1) == 0 or len(seq2) == 0:
        return AlnResult(), [], len(seq1), 0
    mtx = B8.set_score_matrix(M, X)
    qb, qe = 0, len(seq1)
    tb, te = 0, len(seq2)
    if qe > overlap:
        qb = qe - overlap
    if te > overlap:
        te = overlap
    rs, cigars = _align(seq1[qb:qe], seq2[tb:te], mtx, O, E, name, device)
    if rs.aln < int(0.5 * overlap) or rs.mat < int(rs.aln * 0.9):
        maxl = min(len(seq1), len(seq2), overlap * 4)
        qb, qe = 0, len(seq1)
        tb, te = 0, len(seq2)
        if qe > maxl:
            qb = qe - maxl
        if te > maxl:
            te = maxl
        rs, cigars = _align(seq1[qb:qe], seq2[tb:te], mtx, O, E, name,
                            device)
    rs.qb += qb
    rs.qe += qb
    rs.tb += tb
    rs.te += tb
    j0, j1 = revise_seq_joint_point(cigars, rs.qe, rs.te)
    return rs, cigars, j0, j1


def run_cat(argv):
    ap = argparse.ArgumentParser(prog="bsalign-tpu-torch cat")
    ap.add_argument("-o", dest="outf", default=None)
    ap.add_argument("-W", type=int, default=1024)
    ap.add_argument("-M", type=int, default=2)
    ap.add_argument("-X", type=int, default=-6)
    ap.add_argument("-O", type=int, default=-3)
    ap.add_argument("-E", type=int, default=-2)
    ap.add_argument("-v", action="count", default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("inputs", nargs="*")
    args = ap.parse_args(argv)
    from ..cli import resolve_device
    device = resolve_device(args.device)
    out = open(args.outf, "w") if args.outf else sys.stdout
    try:
        cns = _cat_records(args, device)
        out.write(f">cns len={len(cns)}\n")
        for b in range(0, len(cns), 100):
            out.write("".join("ACGTN-"[c] for c in cns[b:b + 100]) + "\n")
    except ValueError as e:
        sys.stderr.write(f"{e}\n")
        return 1
    finally:
        if args.outf:
            out.close()
    return 0


def _cat_records(args, device: torch.device) -> List[int]:
    cns: List[int] = []
    for path in args.inputs:
        for rec in S.read_fastx(path):
            ctg = S.encode_dna(rec.seq, mask_n=False)
            ol = args.W
            if rec.desc and "overlap=" in rec.desc.lower():
                idx = rec.desc.lower().index("overlap=")
                try:
                    ol = int(rec.desc[idx + 8:].split()[0].split(",")[0])
                except ValueError:
                    pass
            if len(cns) == 0:
                cns = list(ctg)
            else:
                cnsa = np.array(cns, np.uint8)
                rs, cigars, j0, j1 = cat_cns_seqs(
                    cnsa, ctg, ol, args.M, args.X, args.O, args.E,
                    device=device, name=rec.tag)
                del cns[j0:]
                if j1 < len(ctg):
                    if rs.aln == 0 or (rs.aln < ol // 2 and rs.aln < 50) \
                            or rs.mat < rs.aln // 2:
                        cns.extend([4] * 6)
                        j1 = 0
                    cns.extend(int(b) for b in ctg[j1:])
    return cns
