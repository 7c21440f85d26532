"""Batched pairwise alignment driver: device forward DP + host traceback
(port of bsalign_tpu.align.pairwise).

The device computes every DP row of a batch of pairs; the host walks the
rows into CIGARs with the native library, whose decisions are those of
the reference's backcal (bsalign.h:3704-3852). On a CUDA device the
forward is the hand-written kernel; on the CPU it is the plain PyTorch
version. What the device emits follows the gap costs and the target
length T (rows, rounded up to 128):

- piecewise 0/1: packed 4-bit traceback codes, walked by the codes walker;
- piecewise 2 (-Q/-P): the int8 u/e/q planes and stripe anchors, walked
  by backcal;
- T > T_CHUNK: the forward runs in resumable row chunks of T_CHUNK rows,
  the device state carried from one chunk to the next;
- T > REALIGN_T with codes (the two-pass long-read mode): a scores-only
  forward keeps each chunk's entry state, then the chunks are re-run in
  reverse order emitting codes, and the resumable walker consumes each
  chunk while the device re-runs the one before it.

Each launch's per-row outputs, with what the driver holds of them, stay
within LAUNCH_BYTES (`_launch_plan`): a batch whose pairs need more runs
in groups of fewer pairs, one group after another, and the two-pass mode
first takes fewer rows per chunk. Pairs are independent and chunks resume
exactly, so the results are those of one launch.
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
T_CHUNK = 4096      # rows per device call for long targets (bounds the
                    # device memory held by per-row outputs)
REALIGN_T = 16384   # beyond this many rows, score first and re-forward row
                    # chunks on demand for the traceback (two-pass mode)
# bytes of one launch's per-row outputs that the driver holds at once: on
# the device, then again on the host (the pinned copy, or the joined row
# chunks), so a launch holds about twice this
LAUNCH_BYTES = 2 << 30


def _launch_plan(B: int, T: int, W: int, piecewise: int, use_codes: bool):
    """(pairs per launch, rows per chunk) for B pairs of T rows at W
    stripes, so that what a launch holds stays within LAUNCH_BYTES, one
    pair at least:
    - codes (0.5 bytes a cell) of every row, which the walk reads whole
      (T <= REALIGN_T);
    - planes ((piecewise + 1) bytes a cell, anchors, begs) of every row,
      which backcal holds;
    - two-pass (T > REALIGN_T): the codes of one chunk of rows and the
      entry state of every chunk; the chunk is halved (down to 128 rows)
      while the pairs do not fit one launch and a shorter chunk holds less,
      and then the pairs are cut."""
    BW = W * WS
    codes_row = (-(-W // 8) * WS + 1) * 4           # codes and begs
    if not use_codes:
        row = (piecewise + 1) * BW + (WS + 2) * 4   # planes, anchors, begs
        return max(1, min(B, LAUNCH_BYTES // (max(T, 1) * row))), T_CHUNK
    if T <= REALIGN_T:
        return max(1, min(B, LAUNCH_BYTES // (max(T, 1) * codes_row))), \
            T_CHUNK
    state = ((piecewise + 1) * BW + WS + 1 + 8) * 4  # planes, anchors, reg

    def per_pair(tc):
        return tc * codes_row + -(-T // tc) * state
    Tc = T_CHUNK
    while Tc > 128 and B * per_pair(Tc) > LAUNCH_BYTES \
            and per_pair(Tc // 2) < per_pair(Tc):
        Tc //= 2
    return max(1, min(B, LAUNCH_BYTES // per_pair(Tc))), Tc


def _forward_chunked(T, W, mode, piecewise, gapo1, gape1, gapo2, gape2,
                     smax, smin, qpad, qlens, tpad, tlens, mtx5, rby, us0,
                     es0, qs0, ub0, Tc, codes, device):
    """Run the forward in row chunks of Tc rows, each call resuming from
    the previous one's final planes, anchors and registers, and join the
    chunks' per-row outputs: only Tc rows of outputs are on the device at
    a time."""
    us, es, qs, ub = us0, es0, qs0, ub0
    res = None
    parts = []
    for c0 in range(0, T, Tc):
        c1 = min(c0 + Tc, T)
        fwd = K8.make_forward(c1 - c0, W, mode, piecewise, gapo1, gape1,
                              gapo2, gape2, smax, smin, codes=codes,
                              device=device)
        res = fwd(qpad, qlens, tpad[:, c0:c1], tlens, mtx5, rby[c0:c1], us,
                  es, qs, ub, row0=c0,
                  init_reg=None if res is None else res.final_reg)
        parts.append(res.planes)
        us, es, qs = (res.final_planes + [None, None])[:3]
        ub = res.final_ubegs

    def cat(field):
        got = [getattr(p, field) for p in parts]
        return None if got[0] is None else torch.cat(got, 0)

    return res._replace(planes=K8.RowPlanes(*(cat(f) for f in
                                              K8.RowPlanes._fields)))


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
    finisher that fetches results and runs the host traceback. A batch
    past LAUNCH_BYTES runs in groups of pairs, each launched, fetched and
    walked before the next, all in the finisher."""
    B = len(qseqs)
    if bandwidth == 0:
        bandwidth = max(len(q) for q in qseqs)
    bandwidth = roundup(bandwidth, WS)
    W = bandwidth // WS
    piecewise = O.get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth)
    T = roundup(max(len(t) for t in tseqs), 128)
    per, Tc = _launch_plan(B, T, W, piecewise, piecewise < 2)
    if per < B:
        return lambda: [r for c in range(0, B, per) for r in _launch_group(
            qseqs[c:c + per], tseqs[c:c + per], mode, bandwidth, mtx, gapo1,
            gape1, gapo2, gape2, Tc, device)()]
    return _launch_group(qseqs, tseqs, mode, bandwidth, mtx, gapo1, gape1,
                         gapo2, gape2, Tc, device)


def _launch_group(qseqs, tseqs, mode, bandwidth, mtx, gapo1, gape1, gapo2,
                  gape2, Tc, device):
    """Launch the device forward for pairs that share one band (rounded to
    WS) and return their finisher; long targets run in chunks of Tc
    rows."""
    B = len(qseqs)
    W = bandwidth // WS
    piecewise = O.get_piecewise(gapo1, gape1, gapo2, gape2, bandwidth)
    smax = int(mtx.max())
    smin = int(mtx.min())
    qpad, qlens, tpad, tlens, rby, T = _pack_batch(qseqs, tseqs, bandwidth)
    us0, es0, qs0, ub0, _ = _init_state(mode, bandwidth, piecewise, smax,
                                        smin, gapo1, gape1, gapo2, gape2, B)
    # packed 4-bit traceback codes (0.5 bytes per cell) where the walker
    # covers the gap model; 2-piece gaps emit the planes for backcal
    use_codes = piecewise < 2
    fwd_cells = float(np.sum(tlens)) * bandwidth
    t_launch = time.time()
    fwd_args = (qpad, qlens, tpad, tlens, _mtx5(mtx), rby, us0, es0, qs0,
                ub0)
    if T > T_CHUNK:
        if use_codes and T > REALIGN_T:
            return lambda: _twopass_batch(
                T, W, mode, bandwidth, piecewise, gapo1, gape1, gapo2,
                gape2, smax, smin, qseqs, tseqs, fwd_args, Tc, fwd_cells,
                device)
        res0 = _forward_chunked(T, W, mode, piecewise, gapo1, gape1, gapo2,
                                gape2, smax, smin, *fwd_args, Tc=Tc,
                                codes=use_codes, device=device)
        get_res = lambda: res0                               # noqa: E731
    else:
        fwd = K8.make_forward(T, W, mode, piecewise, gapo1, gape1, gapo2,
                              gape2, smax, smin, codes=use_codes,
                              device=device)
        # asynchronous launch: the device starts now; the host fetch (and
        # the blocking wait) happens in the finisher
        call, ops, meta = fwd.prepare(*fwd_args)
        outs = call(*ops)
        get_res = lambda: fwd.unpack(outs, *meta)            # noqa: E731
    return lambda: _finish_batch(
        get_res, qseqs, tseqs, mode, bandwidth, piecewise, mtx, smax,
        smin, gapo1, gape1, gapo2, gape2, tlens, use_codes, fwd_cells,
        t_launch)


def _init_eo(init_row, piecewise, gapo1, gape1, bandwidth):
    """E-open bits of the row before the first (the codes walkers' start)."""
    if piecewise and init_row.es is not None:
        return np.ascontiguousarray(
            init_row.es.T.reshape(-1) == gapo1 + gape1, np.uint8)
    return np.ones(bandwidth, np.uint8)


def _finish_batch(get_res, qseqs, tseqs, mode, bandwidth, piecewise, mtx,
                  smax, smin, gapo1, gape1, gapo2, gape2, tlens, use_codes,
                  fwd_cells, t_launch):
    B = len(qseqs)
    res = get_res()
    planes = res.planes
    metrics.add("banded8_fwd", fwd_cells, time.time() - t_launch)
    t_f0 = time.time()
    if use_codes:
        codes_w = np.ascontiguousarray(planes.codes.numpy())
        fetched = [codes_w]
    else:
        us_p, es_p, qs_p = (None if p is None else
                            np.ascontiguousarray(p.numpy())
                            for p in (planes.us, planes.es, planes.qs))
        ub_p = np.ascontiguousarray(planes.ubegs.numpy(), np.int32)
        fetched = [p for p in (us_p, es_p, qs_p, ub_p) if p is not None]
    begs_p = np.ascontiguousarray(planes.begs.numpy(), np.int32)
    # device->host traffic accounting ("cells" = bytes)
    metrics.add("e2e_fetch", sum(a.nbytes for a in fetched) + begs_p.nbytes,
                time.time() - t_f0)

    init_row = O.row_init(mode, bandwidth, smax, smin, gapo1, gape1, gapo2,
                          gape2)
    is_overlap = mode_type(mode) == MODE_OVERLAP
    if use_codes:
        init_eo = _init_eo(init_row, piecewise, gapo1, gape1, bandwidth)
    else:
        mtx8 = np.ascontiguousarray(mtx, np.int8)
    rss = _base_results(res, mode, tlens)
    t_tb0 = time.time()
    out = []
    for b in range(B):
        rs = rss[b]
        if use_codes:
            cigars = NR.decode_codes(qseqs[b], tseqs[b], codes_w, begs_p,
                                     init_eo, b, is_overlap, bandwidth, rs)
        else:
            cigars = NR.backcal(qseqs[b], tseqs[b], init_row, us_p, es_p,
                                qs_p, ub_p, begs_p, b, is_overlap, bandwidth,
                                mtx8, gapo1, gape1, gapo2, gape2, piecewise,
                                rs)
        out.append((rs, cigars))
    metrics.add("e2e_traceback", B, time.time() - t_tb0)
    return out


def _base_results(res, mode, tlens):
    """Per-pair AlnResult seeded from the forward's score/end positions,
    including the non-global final-row row_max candidate
    (bsalign.h:4039-4044), taken for the whole batch in one native call."""
    score = res.score.numpy().astype(np.int64)
    qe = res.qe.numpy().astype(np.int64)
    te = res.te.numpy().astype(np.int64)
    if mode_type(mode) != MODE_GLOBAL:
        t0 = time.time()
        pos, max_score = NR.row_max_batch(res.final_us.numpy(),
                                          res.final_ubegs.numpy())
        take = max_score > score
        score = np.where(take, max_score, score)
        qe = np.where(take, res.final_rbeg.numpy() + pos, qe)
        te = np.where(take, np.asarray(tlens, np.int64) - 1, te)
        metrics.add("e2e_rowmax", len(score), time.time() - t0)
        metrics.add("e2e_rowmax_taken", int(take.sum()), 0.0)
    return [AlnResult(score=s, qe=q, te=t) for s, q, t in
            zip(score.tolist(), qe.tolist(), te.tolist())]


def _twopass_batch(T, W, mode, bandwidth, piecewise, gapo1, gape1, gapo2,
                   gape2, smax, smin, qseqs, tseqs, fwd_args, Tc, fwd_cells,
                   device):
    """Two-pass long-read alignment: a scores-only chunked forward keeps
    each chunk's entry state (planes, anchors and registers, O(BW*B) per
    chunk), then the chunks are re-forwarded in reverse order emitting
    packed codes, which the native resumable walker consumes chunk by
    chunk. The device holds O(Tc*B) codes and O(T/Tc) small checkpoints
    instead of O(T*B) codes, so 50-100 kb targets run at full batch. The
    re-forward of chunk k-1 is launched before chunk k is walked, so the
    device DP overlaps the host traceback."""
    (qpad, qlens, tpad, tlens, mtx5, rby, us0, es0, qs0, ub0) = fwd_args
    B = len(qseqs)
    t_group = time.time()

    def fwd(c0, c1, **kw):
        return K8.make_forward(c1 - c0, W, mode, piecewise, gapo1, gape1,
                               gapo2, gape2, smax, smin, device=device, **kw)

    # ---- pass 1: scores-only forward, checkpointing chunk-entry state ----
    ck = []
    us, es, qs, ub, reg = us0, es0, qs0, ub0, None
    res = None
    for c0 in range(0, T, Tc):
        c1 = min(c0 + Tc, T)
        ck.append((us, es, qs, ub, reg))
        res = fwd(c0, c1, scores_only=True)(
            qpad, qlens, tpad[:, c0:c1], tlens, mtx5, rby[c0:c1], us, es, qs,
            ub, init_reg=reg, row0=c0)
        us, es, qs = (res.final_planes + [None, None])[:3]
        ub, reg = res.final_ubegs, res.final_reg
    # each chunk's unpack waited for its copies to the host, the last one
    # for the scores: pass 1 ends when _base_results has read them
    rss = _base_results(res, mode, tlens)
    metrics.add("twopass_score", fwd_cells, time.time() - t_group)
    init_row = O.row_init(mode, bandwidth, smax, smin, gapo1, gape1, gapo2,
                          gape2)
    init_eo = _init_eo(init_row, piecewise, gapo1, gape1, bandwidth)
    is_overlap = mode_type(mode) == MODE_OVERLAP
    qflat = np.ascontiguousarray(np.concatenate(
        [np.asarray(q, np.uint8) for q in qseqs]))
    tflat = np.ascontiguousarray(np.concatenate(
        [np.asarray(t, np.uint8) for t in tseqs]))
    qoffs = np.zeros(B + 1, np.int64)
    qoffs[1:] = np.cumsum([len(q) for q in qseqs])
    toffs = np.zeros(B + 1, np.int64)
    toffs[1:] = np.cumsum([len(t) for t in tseqs])
    st = NR.walk_init([rs.qe for rs in rss], [rs.te for rs in rss])
    cg_buf = np.zeros((B, 2 * Tc + 64), np.uint32)
    parts = [[] for _ in range(B)]

    walk_s = 0.0

    def walk_chunk(pend):
        nonlocal walk_s
        get, c0, c1, regk = pend
        t0 = time.time()
        r = get()
        t1 = time.time()
        codes_c = np.ascontiguousarray(r.planes.codes.numpy())
        begs_c = np.ascontiguousarray(r.planes.begs.numpy(), np.int32)
        t2 = time.time()
        metrics.add("banded8_refwd", float(B) * (c1 - c0) * bandwidth,
                    t2 - t0)
        metrics.add("e2e_fetch", codes_c.nbytes + begs_c.nbytes, t2 - t1)
        beg_prev = (np.zeros(B, np.int32) if regk is None else
                    np.ascontiguousarray(np.asarray(regk)[0], np.int32))
        NR.walk_codes_chunk(qflat, qoffs, tflat, toffs, codes_c, begs_c,
                            beg_prev, init_eo, c0, c1, is_overlap, bandwidth,
                            st, cg_buf)
        walk_s += time.time() - t2
        for b in range(B):
            n = int(st[b, NR.WK_NCG])
            if n:
                parts[b].append(cg_buf[b, :n].copy())

    # ---- pass 2: reverse chunk re-forward (codes) + incremental walk ----
    pend = None
    for k in range(-(-T // Tc) - 1, -1, -1):
        c0 = k * Tc
        c1 = min(c0 + Tc, T)
        usk, esk, qsk, ubk, regk = ck[k]
        fwd_c = fwd(c0, c1, codes=True)
        call, ops, meta = fwd_c.prepare(
            qpad, qlens, tpad[:, c0:c1], tlens, mtx5, rby[c0:c1], usk, esk,
            qsk, ubk, regk, c0)
        outs = call(*ops)
        get = (lambda fwd_c=fwd_c, outs=outs, meta=meta:
               fwd_c.unpack(outs, *meta))
        if pend is not None:
            walk_chunk(pend)
        pend = (get, c0, c1, regk)
    walk_chunk(pend)
    metrics.add("e2e_traceback", B, walk_s)

    out = []
    for b in range(B):
        s = st[b]
        if int(s[NR.WK_DONE]) != 1:
            raise RuntimeError("chunked codes walk did not complete")
        rs = rss[b]
        rs.qb = int(s[NR.WK_QB]) + 1
        rs.tb = int(s[NR.WK_TB]) + 1
        rs.qe += 1
        rs.te += 1
        rs.mat = int(s[NR.WK_MAT])
        rs.mis = int(s[NR.WK_MIS])
        rs.ins = int(s[NR.WK_INS])
        rs.dele = int(s[NR.WK_DEL])
        rs.aln = int(s[NR.WK_ALN])
        words = (np.concatenate(parts[b]) if parts[b]
                 else np.zeros(0, np.uint32))
        out.append((rs, [int(x) for x in words[::-1]]))
    metrics.add("twopass_launch", B, time.time() - t_group)
    return out
