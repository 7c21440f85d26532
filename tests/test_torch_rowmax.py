"""The non-global final-row maximum of `align`, on the CPU:

- `native.rowops.row_max_batch` (one native call a batch, the tie-break
  tree of `rowops.cpp` `arena_row_max`) against `oracle.banded8.row_max`,
  pair by pair, on random and tied rows, rows outside the int8 range and
  anchors near SCORE_MIN, at W from 1 to 2,000;
- `align.pairwise._base_results` against the per-pair loop over
  `oracle.banded8.row_max` it replaced (kept here as the reference), on the
  CPU forward's results of overlap, extend and global batches, the
  two-pass route included: every AlnResult field equal;
- the `e2e_rowmax` and `e2e_rowmax_taken` counters: one add a chunk, the
  pairs scanned, none for a global batch.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.cigar import AlnResult
from bsalign_tpu_torch.constants import (MODE_EXTEND, MODE_GLOBAL,
                                         MODE_OVERLAP, SCORE_MIN, WORDSIZE,
                                         mode_type)
from bsalign_tpu_torch.native import rowops as NR
from bsalign_tpu_torch.oracle import banded8 as O
from bsalign_tpu_torch.utils import metrics

from .util import gen_pair

torch.set_num_threads(1)

WS = WORDSIZE
WIDTHS = [1, 2, 31, 32, 33, 64, 125, 128, 2000]


def _rows(kind, W, B, rng):
    """final_us [W, WS, B] int32 and final_ubegs [WS + 1, B] int32 as the
    forward returns them, of one kind of row."""
    ub = np.cumsum(rng.integers(-40, 41, (WS + 1, B)), axis=0)
    if kind == "random":
        us = rng.integers(-128, 128, (W, WS, B))
    elif kind == "zeros":
        us = np.zeros((W, WS, B), np.int64)
        ub[:] = 7
    elif kind == "tied_lanes":
        # several lanes hold the same stripes over the same anchor
        us = rng.integers(-6, 7, (W, WS, B))
        for b in range(B):
            lanes = rng.choice(WS, 1 + int(rng.integers(2, 6)), replace=False)
            us[:, lanes[1:], b] = us[:, lanes[:1], b]
            ub[lanes[1:], b] = ub[lanes[0], b]
    elif kind == "tied_steps":
        # each 32-stripe step reaches the same maximum from the same carry
        step = rng.integers(-5, 6, (32, WS, B))
        step[-1] -= step.sum(axis=0)
        us = np.tile(step, (-(-W // 32), 1, 1))[:W]
        ub[:WS] = ub[:1]
    elif kind == "wrap":
        # outside int8: wraps as astype(np.int8) does
        us = rng.integers(-400, 400, (W, WS, B))
    elif kind == "near_min":
        us = rng.integers(-128, 128, (W, WS, B))
        ub = SCORE_MIN + rng.integers(-300, 300, (WS + 1, B))
        ub[rng.random((WS + 1, B)) < 0.5] = SCORE_MIN
    else:
        raise ValueError(kind)
    return us.astype(np.int32), ub.astype(np.int32)


def _oracle_row_max(final_us, final_ubegs, b):
    st = O.RowState.__new__(O.RowState)
    st.us = final_us[:, :, b].astype(np.int8)
    st.es = st.qs = None
    st.ubegs = final_ubegs[:, b].astype(np.int64)
    return O.row_max(st, final_us.shape[0])


@pytest.mark.parametrize("kind", ["random", "zeros", "tied_lanes",
                                  "tied_steps", "wrap", "near_min"])
@pytest.mark.parametrize("W", WIDTHS)
def test_row_max_batch_matches_oracle(W, kind):
    rng = np.random.default_rng(1000 * W + len(kind))
    B = 3 if W > 128 else 9
    us, ub = _rows(kind, W, B, rng)
    pos, score = NR.row_max_batch(us, ub)
    assert pos.dtype == score.dtype == np.int64
    assert pos.shape == score.shape == (B,)
    for b in range(B):
        assert (int(pos[b]), int(score[b])) == _oracle_row_max(us, ub, b), b


def _old_base_results(res, mode, W, tlens):
    """The per-pair loop that `_base_results` ran before the native call."""
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
            rmax, max_score = _oracle_row_max(fin_us, fin_ub, b)
            if max_score > rs.score:
                rs.score = max_score
                rs.qe = int(fin_rbeg[b]) + rmax
                rs.te = int(tlens[b]) - 1
        rss.append(rs)
    return rss


def _batch(seed):
    """Pairs whose best end lies on the final row (queries run past their
    targets) and pairs whose best end lies before it (targets run past
    their queries), of a few lengths and error rates."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for L, err in ((180, 0.1), (230, 0.15), (200, 0.2), (240, 0.05)):
        q, t = gen_pair(rng, L, err)
        tail = rng.integers(0, 4, int(rng.integers(20, 60))).astype(np.uint8)
        qs += [np.concatenate([q, tail]), q]
        ts += [t, np.concatenate([t, tail])]
    return qs, ts


def _align_seen(monkeypatch, mode, band, gaps, seed):
    """Align a batch on the CPU; every (res, tlens) that reached
    _base_results, with copies of the AlnResults it returned (the walk
    then fills them in)."""
    seen = []
    real = P._base_results

    def spy(res, mode_, tlens):
        out = real(res, mode_, tlens)
        seen.append((res, tlens, [AlnResult(**vars(a)) for a in out]))
        return out

    monkeypatch.setattr(P, "_base_results", spy)
    qs, ts = _batch(seed)
    P.align_batch(qs, ts, mode, band, O.set_score_matrix(2, -6), *gaps,
                  device="cpu")
    return seen


AFFINE = (-3, -2, 0, 0)
CASES = [(MODE_OVERLAP, 64, AFFINE, False),
         (MODE_OVERLAP, 0, (0, -4, 0, 0), False),
         (MODE_OVERLAP, 32, (-4, -2, -24, -1), False),   # planes
         (MODE_EXTEND, 64, AFFINE, False),
         (MODE_EXTEND, 128, (-4, -2, -24, -1), False),
         (MODE_GLOBAL, 64, AFFINE, False),
         (MODE_OVERLAP, 64, AFFINE, True)]                # two-pass


@pytest.mark.parametrize("case", range(len(CASES)))
def test_base_results_match_per_pair_loop(monkeypatch, case):
    mode, band, gaps, twopass = CASES[case]
    if twopass:
        monkeypatch.setattr(P, "T_CHUNK", 128)
        monkeypatch.setattr(P, "REALIGN_T", 128)
        calls = []
        real = P._twopass_batch
        monkeypatch.setattr(P, "_twopass_batch",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    seen = _align_seen(monkeypatch, mode, band, gaps, 31 + case)
    if twopass:
        assert calls == [1]
    assert len(seen) == 1
    res, tlens, got = seen[0]
    W = res.final_us.shape[0]
    want = _old_base_results(res, mode, W, tlens)
    assert [vars(a) for a in got] == [vars(a) for a in want]
    if mode_type(mode) != MODE_GLOBAL:
        # both kinds of end occur, so the comparison covers both branches
        moved = [a.te == int(t) - 1 and a.score > int(s) for a, t, s in
                 zip(got, tlens, res.score.numpy())]
        assert any(moved) and not all(moved)


@pytest.mark.parametrize("mode", [MODE_OVERLAP, MODE_EXTEND, MODE_GLOBAL])
def test_rowmax_counters(monkeypatch, mode):
    monkeypatch.setattr(P, "DEVICE_CHUNK", 3)
    metrics.reset()
    seen = _align_seen(monkeypatch, mode, 64, AFFINE, 7)
    ctr = metrics.counters()
    assert len(seen) == 3                          # 8 pairs, chunks of 3
    if mode == MODE_GLOBAL:
        assert "e2e_rowmax" not in ctr and "e2e_rowmax_taken" not in ctr
        return
    scanned, taken = ctr["e2e_rowmax"], ctr["e2e_rowmax_taken"]
    assert (scanned.cells, scanned.calls) == (8, 3)
    assert scanned.seconds >= 0
    assert taken.calls == 3
    assert 0 < taken.cells <= scanned.cells
    moved = sum(a.te == int(t) - 1 and a.score > int(s)
                for res, tlens, got in seen
                for a, t, s in zip(got, tlens, res.score.numpy()))
    assert taken.cells == moved
