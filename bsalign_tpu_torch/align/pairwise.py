"""Batched pairwise alignment driver: device forward DP + host traceback
(port of bsalign_tpu.align.pairwise on its packed-codes path).

The device computes every DP row of a batch of pairs and emits packed
4-bit traceback codes; the host walks them into CIGARs with the native
walker, whose decisions are those of the reference's backcal
(bsalign.h:3704-3852). On a CUDA device the forward is the hand-written
kernel; on the CPU it is the plain PyTorch version. Both run all T rows
of a batch in one launch.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cigar import AlnResult
from ..constants import (MODE_GLOBAL, MODE_OVERLAP, SCORE_EPI8_MIN,
                         WORDSIZE, mode_type, roundup)
from ..native import rowops as NR
from ..ops import banded8 as K8
from ..oracle import banded8 as O
from ..utils import metrics

WS = WORDSIZE


def _pack_batch(qseqs: Sequence[np.ndarray], tseqs: Sequence[np.ndarray],
                bandwidth: int):
    B = len(qseqs)
    qlens = np.array([len(q) for q in qseqs], np.int32)
    tlens = np.array([len(t) for t in tseqs], np.int32)
    C = 1
    while C < bandwidth + bandwidth // WS:
        C *= 2
    QP = roundup(int(qlens.max()) + bandwidth + WS + 1, C)
    # bucket the row count so nearby batch shapes share one geometry
    T = roundup(int(tlens.max()), 128)
    qpad = np.full((B, QP), 4, np.int32)
    tpad = np.zeros((B, T), np.int32)
    for i, (q, t) in enumerate(zip(qseqs, tseqs)):
        qpad[i, : len(q)] = q
        tpad[i, : len(t)] = t
    # host-precomputed double-rounded diagonal targets (bsalign.h:4009)
    i_idx = np.arange(T, dtype=np.float64)[:, None]
    rby = ((i_idx / tlens[None, :].astype(np.float64))
           * qlens[None, :].astype(np.float64)).astype(np.int32)
    return qpad, qlens, tpad, tlens, rby, T


def _mtx5(mtx: np.ndarray) -> np.ndarray:
    m5 = np.full((5, 4), SCORE_EPI8_MIN, np.int32)
    m5[:4, :] = mtx.reshape(4, 4)
    return m5


def _init_state(mode, bandwidth, piecewise, smax, smin, gapo1, gape1, gapo2,
                gape2, B):
    st = O.row_init(mode, bandwidth, smax, smin, gapo1, gape1, gapo2, gape2)
    W = bandwidth // WS
    us = np.broadcast_to(st.us.astype(np.int32)[:, :, None], (W, WS, B)).copy()
    ub = np.broadcast_to(st.ubegs.astype(np.int32)[:, None], (WS + 1, B)).copy()
    es = qs = None
    if piecewise:
        es = np.broadcast_to(st.es.astype(np.int32)[:, :, None], (W, WS, B)).copy()
    if piecewise == 2:
        qs = np.broadcast_to(st.qs.astype(np.int32)[:, :, None], (W, WS, B)).copy()
    return us, es, qs, ub, st


DEVICE_CHUNK = 256  # pairs per forward launch


def align_batch(qseqs: Sequence[np.ndarray], tseqs: Sequence[np.ndarray],
                mode: int, bandwidth: int, mtx: np.ndarray, gapo1: int,
                gape1: int, gapo2: int, gape2: int, *, device,
                ) -> List[Tuple[AlnResult, List[int]]]:
    """Align a batch of (query, target) pairs on `device`; same bandwidth
    for all.

    bandwidth == 0 means full band per pair (only valid when all queries pad
    to one bucket; the CLI buckets by rounded qlen first). Batches larger
    than DEVICE_CHUNK run as a depth-2 pipeline: chunk k+1's forward is
    launched before chunk k's results are fetched and walked on the host.
    """
    device = torch.device(device)
    if len(qseqs) > DEVICE_CHUNK:
        out: List[Tuple[AlnResult, List[int]]] = []
        pending = None
        for c in range(0, len(qseqs), DEVICE_CHUNK):
            nxt = _launch_batch(qseqs[c:c + DEVICE_CHUNK],
                                tseqs[c:c + DEVICE_CHUNK], mode, bandwidth,
                                mtx, gapo1, gape1, gapo2, gape2, device)
            if pending is not None:
                out.extend(pending())
            pending = nxt
        out.extend(pending())
        return out
    return _launch_batch(qseqs, tseqs, mode, bandwidth, mtx, gapo1, gape1,
                         gapo2, gape2, device)()


def _launch_batch(qseqs, tseqs, mode, bandwidth, mtx, gapo1, gape1, gapo2,
                  gape2, device):
    """Launch the device forward for one batch and return a zero-arg
    finisher that fetches results and runs the host traceback."""
    B = len(qseqs)
    if bandwidth == 0:
        bandwidth = max(len(q) for q in qseqs)
    bandwidth = roundup(bandwidth, WS)
    W = bandwidth // WS
    piecewise = O.get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth)
    if piecewise == 2:
        raise NotImplementedError(
            "2-piece gap costs (-Q/-P) need the banded-8 planes emit and the "
            "backcal traceback, a later ROADMAP item")
    smax = int(mtx.max())
    smin = int(mtx.min())
    qpad, qlens, tpad, tlens, rby, T = _pack_batch(qseqs, tseqs, bandwidth)
    us0, es0, qs0, ub0, _ = _init_state(mode, bandwidth, piecewise, smax,
                                        smin, gapo1, gape1, gapo2, gape2, B)
    fwd_cells = float(np.sum(tlens)) * bandwidth
    t_launch = time.time()
    fwd = K8.make_forward(T, W, mode, piecewise, gapo1, gape1, gapo2, gape2,
                          smax, smin, codes=True, device=device)
    call, ops, meta = fwd.prepare(qpad, qlens, tpad, tlens, _mtx5(mtx), rby,
                                  us0, es0, qs0, ub0)
    outs = call(*ops)
    return lambda: _finish_batch(
        lambda: fwd.unpack(outs, *meta), qseqs, tseqs, mode, bandwidth, W,
        piecewise, smax, smin, gapo1, gape1, gapo2, gape2, tlens, fwd_cells,
        t_launch)


def _finish_batch(get_res, qseqs, tseqs, mode, bandwidth, W, piecewise,
                  smax, smin, gapo1, gape1, gapo2, gape2, tlens, fwd_cells,
                  t_launch):
    B = len(qseqs)
    res = get_res()
    metrics.add("banded8_fwd", fwd_cells, time.time() - t_launch)
    t_f0 = time.time()
    codes_w = np.ascontiguousarray(res.planes.codes.numpy())
    begs_p = np.ascontiguousarray(res.planes.begs.numpy(), np.int32)
    # device->host traffic accounting ("cells" = bytes)
    metrics.add("e2e_fetch", codes_w.nbytes + begs_p.nbytes,
                time.time() - t_f0)

    init_row = O.row_init(mode, bandwidth, smax, smin, gapo1, gape1, gapo2,
                          gape2)
    if piecewise and init_row.es is not None:
        init_eo = (init_row.es.T.reshape(-1) == gapo1 + gape1).astype(np.uint8)
    else:
        init_eo = np.ones(bandwidth, np.uint8)
    is_overlap = mode_type(mode) == MODE_OVERLAP
    rss = _base_results(res, mode, W, tlens)
    t_tb0 = time.time()
    out = []
    for b in range(B):
        rs = rss[b]
        cigars = NR.decode_codes(qseqs[b], tseqs[b], codes_w, begs_p,
                                 init_eo, b, is_overlap, bandwidth, rs)
        out.append((rs, cigars))
    metrics.add("e2e_traceback", B, time.time() - t_tb0)
    return out


def _base_results(res, mode, W, tlens):
    """Per-pair AlnResult seeded from the forward's score/end positions,
    including the non-global final-row row_max candidate
    (bsalign.h:4039-4044)."""
    score = res.score.numpy()
    qe = res.qe.numpy()
    te = res.te.numpy()
    fin_us = res.final_us.numpy()
    fin_ub = res.final_ubegs.numpy()
    fin_rbeg = res.final_rbeg.numpy()
    rss = []
    for b in range(len(score)):
        rs = AlnResult(score=int(score[b]), qe=int(qe[b]), te=int(te[b]))
        if mode_type(mode) != MODE_GLOBAL:
            stf = O.RowState.__new__(O.RowState)
            stf.us = fin_us[:, :, b].astype(np.int8)
            stf.es = stf.qs = None
            stf.ubegs = fin_ub[:, b].astype(np.int64)
            rmax, max_score = O.row_max(stf, W)
            if max_score > rs.score:
                rs.score = max_score
                rs.qe = int(fin_rbeg[b]) + rmax
                rs.te = int(tlens[b]) - 1
        rss.append(rs)
    return rss
