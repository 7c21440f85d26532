"""Batched edit-distance driver: device bit-parallel rows + host traceback
(port of bsalign_tpu.align.editdist).

Band trajectories are data-independent (bsalign.h:1108-1117) so they are
precomputed on host; the device runs the Myers-form bit-plane rows for a
whole batch and stores the u-planes per row; the host decodes CIGARs with the
reference's tie-break priority (match > I > D > mismatch). On a CUDA device
the forward is the hand-written kernel (csrc/edit.cu); on the CPU it is the
plain PyTorch version. Chunks of DEVICE_CHUNK pairs run one after another,
each cut into launches whose planes stay within LAUNCH_BYTES.

The kmer-guided mode chains unique kmer anchors on host (oracle logic) and
batch-aligns all inter-anchor segments on device, grouped by bandwidth.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cigar import AlnResult
from ..constants import (MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP,
                         mode_type, roundup)
from ..ops import edit as K
from ..oracle import edit as OE
from ..utils import metrics

MAX_B4 = OE.MAX_B4
DEVICE_CHUNK = 256
# bytes of one launch's per-row outputs (pm and pp, 8 bytes a word, and
# sbeg), which the host copies whole: a launch holds about twice this
LAUNCH_BYTES = 2 << 30


def _launch_pairs(T: int, NW: int) -> int:
    """Pairs per launch of T rows at NW words within LAUNCH_BYTES, one at
    least."""
    return max(1, LAUNCH_BYTES // (max(T, 1) * (8 * NW + 4)))


def _band_trajectory(qlen: int, tlen: int, bandwidth: int, banded: bool,
                     T: int) -> Tuple[np.ndarray, np.ndarray]:
    rbegs = np.zeros(T, np.int32)
    if banded:
        qro = roundup(qlen, 64)
        for i in range(min(tlen, T)):
            r = (i * qlen) // tlen
            r = 0 if r < bandwidth // 2 else r - bandwidth // 2
            if r + bandwidth > qro:
                r = qro - bandwidth
            rbegs[i] = r
    movxs = np.diff(rbegs, prepend=0).astype(np.int32)
    return rbegs, movxs


def _qeq_planes(qseqs: Sequence[np.ndarray], NWQ: int) -> np.ndarray:
    """[4, B, NWQ] uint32: bit x of word w = (qseq[32w + x] == base)."""
    B = len(qseqs)
    out = np.zeros((4, B, NWQ), np.uint32)
    for b, q in enumerate(qseqs):
        bits = np.zeros((4, NWQ * 32), bool)
        for v in range(4):
            bits[v, : len(q)] = q == v
        packed = np.packbits(bits.reshape(4, NWQ, 32)[:, :, ::-1], axis=2,
                             bitorder="big")
        out[:, b, :] = packed.reshape(4, NWQ, 4).view(">u4")[:, :, 0]
    return out


def _unpack_u_rows(pm: np.ndarray, pp: np.ndarray, bw: int) -> np.ndarray:
    """Bit-planes [R, NW] uint32 -> [R, bw] int8 u values, all rows at once.

    Band position p maps to bit p%32 of word p//32 (striped_seqedit_getval,
    bsalign.h:224): little-endian byte+bit order, so one unpackbits over the
    raw bytes decodes a whole pair's row block without a Python row loop."""
    R = pm.shape[0]
    mb = np.unpackbits(
        np.ascontiguousarray(pm, np.uint32).view(np.uint8).reshape(R, -1),
        axis=1, bitorder="little")[:, :bw]
    pb = np.unpackbits(
        np.ascontiguousarray(pp, np.uint32).view(np.uint8).reshape(R, -1),
        axis=1, bitorder="little")[:, :bw]
    return pb.astype(np.int8) - mb.astype(np.int8)


def _pack_bucket(qseqs, tseqs, bandwidth: int, banded: bool):
    """The forward's numpy operands for pairs that share one bandwidth:
    (T, NWQ, (qeq, qlens, tpad, tlens, rbegs, movxs))."""
    B = len(qseqs)
    qlens = np.array([len(q) for q in qseqs], np.int32)
    tlens = np.array([len(t) for t in tseqs], np.int32)
    T = roundup(int(tlens.max()), 128)  # bucket rows like the JAX driver
    NW = bandwidth // 32
    # the window at the deepest rbeg (<= roundup(qlen, 64) - bw) reads
    # NW + 1 words; past the query every word is 0
    need = max(int(np.ceil((int(qlens.max()) + 1) / 32)), NW + 1)
    NWQ = need + NW + 1
    tpad = np.zeros((B, T), np.int32)
    rbegs = np.zeros((T, B), np.int32)
    movxs = np.zeros((T, B), np.int32)
    for b in range(B):
        tpad[b, : tlens[b]] = tseqs[b]
        rbegs[:, b], movxs[:, b] = _band_trajectory(
            int(qlens[b]), int(tlens[b]), bandwidth, banded, T)
    return T, NWQ, (_qeq_planes(qseqs, NWQ), qlens, tpad, tlens, rbegs,
                    movxs)


def _edit_bucket(qseqs, tseqs, mode, bandwidth, banded, device
                 ) -> List[Tuple[AlnResult, List[int]]]:
    """All pairs share one bandwidth (and banded-ness)."""
    B = len(qseqs)
    bw = bandwidth
    T, NWQ, ops = _pack_bucket(qseqs, tseqs, bw, banded)
    _, qlens, _, tlens, rbegs, _ = ops
    fwd = K.make_edit_forward(T, bw // 32, mode, NWQ, banded, device=device)
    with metrics.timed("edit_fwd", float(np.sum(tlens)) * bw):
        res = fwd(*ops)
    pm_t, pp_t = res.pm, res.pp
    smin, ry_a = res.smin, res.ry
    score_g, sbeg_f = res.final_score, res.final_sbeg

    out = []
    mt = mode_type(mode)
    for b in range(B):
        qlen, tlen = int(qlens[b]), int(tlens[b])
        if qlen == 0 or tlen == 0:
            out.append((AlnResult(), []))
            continue
        uts = np.ones((tlen + 1, bw), np.int8)
        uts[1:] = _unpack_u_rows(pm_t[:tlen, :, b], pp_t[:tlen, :, b], bw)
        begs = [0] + [int(rbegs[i, b]) for i in range(tlen)]
        rx, ry = qlen - 1, tlen - 1
        sm = int(smin[b])
        if mt in (MODE_OVERLAP, MODE_EXTEND) and sm < MAX_B4:
            ry = int(ry_a[b])
        if mt == MODE_EXTEND:
            pref = int(sbeg_f[b]) + np.cumsum(uts[tlen].astype(np.int64))
            k = int(np.argmin(pref))
            if int(pref[k]) < sm:
                sm = int(pref[k])
                rx, ry = k, tlen - 1
        rs, cigars = OE.edit_backtrace(uts, begs, qseqs[b], rx, tseqs[b], ry,
                                       mode)
        if mt == MODE_OVERLAP:
            rs.score = sm + rs.te - rs.tb
        elif mt == MODE_EXTEND:
            rs.score = sm
        else:
            rs.score = int(score_g[b])
        out.append((rs, cigars))
    return out


def edit_batch(qseqs: Sequence[np.ndarray], tseqs: Sequence[np.ndarray],
               mode: int, bandwidth: int, *, device
               ) -> List[Tuple[AlnResult, List[int]]]:
    """Batch edit alignment on `device` with the reference's per-pair band
    selection (bsalign.h:1055-1067); pairs are bucketed by effective
    bandwidth."""
    device = torch.device(device)
    buckets = {}
    for i, (q, t) in enumerate(zip(qseqs, tseqs)):
        if len(q) == 0 or len(t) == 0:
            buckets.setdefault(None, []).append(i)
            continue
        bw = OE._select_bandwidth(len(q), len(t), mode, bandwidth)
        banded = (mode_type(mode) not in (MODE_OVERLAP, MODE_EXTEND)
                  and bw < len(q))
        if not banded:
            # full-band: widening is output-neutral (cells past qlen are
            # masked) and coarser buckets share one geometry
            bw = roundup(bw, 256)
        buckets.setdefault((bw, banded), []).append(i)
    results: List = [None] * len(qseqs)
    for key, idxs in buckets.items():
        if key is None:
            for i in idxs:
                results[i] = (AlnResult(), [])
            continue
        bw, banded = key
        for c in range(0, len(idxs), DEVICE_CHUNK):
            chunk = idxs[c:c + DEVICE_CHUNK]
            T = roundup(max(len(tseqs[i]) for i in chunk), 128)
            per = _launch_pairs(T, bw // 32)
            for g in range(0, len(chunk), per):
                part = chunk[g:g + per]
                outs = _edit_bucket([qseqs[i] for i in part],
                                    [tseqs[i] for i in part], mode, bw,
                                    banded, device)
                for i, r in zip(part, outs):
                    results[i] = r
    return results


def kmer_edit_batch(ksz: int, qseqs: Sequence[np.ndarray],
                    tseqs: Sequence[np.ndarray], *, device
                    ) -> List[Tuple[AlnResult, List[int]]]:
    """Kmer-synteny chained edit alignment for a batch: host chaining, then
    one device-batched pass over all inter-anchor segments."""
    if ksz > 15:
        ksz = 15
    B = len(qseqs)
    chains = [OE._kmer_chain(q, t, ksz) for q, t in zip(qseqs, tseqs)]
    # collect segments: (pair, segno, mode, qseg, tseg)
    segs = []
    for b in range(B):
        if not chains[b]:
            segs.append((b, 0, MODE_GLOBAL, qseqs[b], tseqs[b], False))
            continue
        chain = chains[b]
        qb = tb = 0
        for i in range(len(chain) + 1):
            if i == len(chain):
                qe, te = len(qseqs[b]), len(tseqs[b])
                m = MODE_EXTEND
                rev = False
            else:
                qe = chain[i][0] + ksz // 2
                te = chain[i][1] + ksz // 2
                m = MODE_EXTEND if i == 0 else MODE_GLOBAL
                rev = i == 0
            if not (qb == qe and tb == te):
                if rev:
                    qseg = qseqs[b][:qe][::-1].copy()
                    tseg = tseqs[b][:te][::-1].copy()
                else:
                    qseg = qseqs[b][qb:qe]
                    tseg = tseqs[b][tb:te]
                segs.append((b, i, m, qseg, tseg, rev))
            qb, tb = qe + 1, te + 1
    # batch-align segments grouped by mode (bandwidth = full per segment)
    seg_results = {}
    by_mode = {}
    for si, s in enumerate(segs):
        by_mode.setdefault(s[2], []).append(si)
    for m, sis in by_mode.items():
        outs = edit_batch([segs[si][3] for si in sis],
                          [segs[si][4] for si in sis], m, 0, device=device)
        for si, r in zip(sis, outs):
            seg_results[si] = r
    # assemble per pair, mirroring kmer_striped_seqedit_pairwise
    seg_by_pair = {}
    for si, s in enumerate(segs):
        seg_by_pair.setdefault(s[0], {})[s[1]] = (s, seg_results[si])
    results = []
    for b in range(B):
        if not chains[b]:
            results.append(seg_by_pair[b][0][1])
            continue
        chain = chains[b]
        RS = AlnResult()
        cigars: List[int] = []

        def push(op, sz):
            if cigars and (cigars[-1] & 0xF) == op:
                cigars[-1] += sz << 4
            else:
                cigars.append((sz << 4) | op)

        qb = tb = ml = 0
        for i in range(len(chain) + 1):
            if i == len(chain):
                qe, te = len(qseqs[b]), len(tseqs[b])
            else:
                qe = chain[i][0] + ksz // 2
                te = chain[i][1] + ksz // 2
                ml += 1
            if not (qb == qe and tb == te):
                if ml:
                    push(0, ml)
                    RS.mat += ml
                    RS.aln += ml
                    ml = 0
                (s, (rs2, cg2)) = seg_by_pair[b][i]
                if s[5]:  # reversed head segment
                    cigars.extend(cg2)
                    cigars.reverse()
                    RS.qb = qe - rs2.qe
                    RS.tb = te - rs2.te
                    RS.qe = qe
                    RS.te = te
                else:
                    for cg in cg2:
                        push(cg & 0xF, cg >> 4)
                    RS.qe = qb + rs2.qe
                    RS.te = tb + rs2.te
                RS.mat += rs2.mat
                RS.mis += rs2.mis
                RS.ins += rs2.ins
                RS.dele += rs2.dele
                RS.aln += rs2.aln
                RS.score += rs2.score
            qb, tb = qe + 1, te + 1
        results.append((RS, cigars))
    return results


def epi2_edit_batch(qseqs: Sequence[np.ndarray], tseqs: Sequence[np.ndarray],
                    *, device) -> List[Tuple[AlnResult, List[int]]]:
    """Library equivalent of the reference's 2-bit packed full-matrix edit
    engine (striped_epi2_seqedit_pairwise, bsalign.h:1538-2082).

    The reference stores each cell's u-delta as a 2-bit code and resolves
    the horizontal carry by re-scanning; the bit-plane forward holds the
    same two bits per cell in a minus- and a plus-plane and computes the
    same fixpoint in closed form, so it shares the forward with
    `edit_batch` at full band, with the same backtrace priority
    (bsalign.h:1704-1795 == :965-1044).

    Reference-faithful driver semantics reproduced here (they differ from
    ``edit_batch(mode=GLOBAL, bw=0)``):
    - the mode argument is UNUSED upstream (:2008, ``UNUSED(mode)``) —
      always global full-matrix;
    - the epi2 backtrace never assigns ``rs.score`` (:1708 zeroes the
      struct and nothing writes score) — results carry score == 0;
    - empty query/target still walk the boundary absorption (:1766-1789):
      leading rows/columns become one pure I/D run instead of the empty
      result the banded driver returns."""
    out: List = [None] * len(qseqs)
    live_idx = []
    for i, (q, t) in enumerate(zip(qseqs, tseqs)):
        qlen, tlen = len(q), len(t)
        if qlen and tlen:
            live_idx.append(i)
            continue
        # degenerate pairs: while-loop skipped, qb/tb absorbed (:1766-1789)
        rs = AlnResult()
        rs.qe, rs.te = qlen, tlen
        cigars: List[int] = []
        if qlen:
            rs.ins = qlen
            cigars.append((qlen << 4) | 1)
        if tlen:
            rs.dele = tlen
            cigars.append((tlen << 4) | 2)
        rs.aln = rs.ins + rs.dele
        out[i] = (rs, cigars)
    if live_idx:
        res = edit_batch([qseqs[i] for i in live_idx],
                         [tseqs[i] for i in live_idx], MODE_GLOBAL, 0,
                         device=device)
        for i, (rs, cigars) in zip(live_idx, res):
            rs.score = 0    # ZEROS(&rs) and never assigned (:1708)
            out[i] = (rs, cigars)
    return out


def epi2_edit_pairwise(qseq: np.ndarray, tseq: np.ndarray, *, device
                       ) -> Tuple[AlnResult, List[int]]:
    """Single-pair entry mirroring striped_epi2_seqedit_pairwise
    (bsalign.h:2002-2082)."""
    return epi2_edit_batch([qseq], [tseq], device=device)[0]
