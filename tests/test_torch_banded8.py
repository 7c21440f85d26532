"""The port's banded-8 forward (bsalign_tpu_torch.ops.banded8) against the
JAX package on identical numpy operands, on the CPU.

- The plain PyTorch forward against bsalign_tpu.ops.banded8_jax: every
  active row's u/e/q planes, stripe anchors and band offsets, the score and
  end cell, and the final state, for global/overlap/extend x piecewise 0/1/2
  at W in {1, 2, 8}.
- The plain codes against the JAX package's extractor
  (bsalign_tpu.align.btcodes.codes_from_rows) applied to the same rows.
- The plain codes and begs against the Pallas kernel in interpret mode.
- The plain forward run in resumed row chunks (init_reg/row0) against its
  one-shot run, for every emit; the scores-only emit against the planes
  and codes emits; planes rows at and past tlen.
- The CUDA kernel's byte query operand (`query_bytes`).

The hand-written CUDA kernel is held against the plain version on the card
in test_torch_cuda.py.

All comparisons are exact: the arithmetic is integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsalign_tpu.align import btcodes as BC
from bsalign_tpu.align import pairwise as JP
from bsalign_tpu.constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu.oracle import banded8 as JO
from bsalign_tpu.ops import banded8_jax as KJ
from bsalign_tpu.ops import banded8_pallas as KP
from bsalign_tpu_torch.ops import banded8 as K

from .util import gen_pair

torch.set_num_threads(1)

AFFINE = (-3, -2, 0, 0)        # piecewise 1
LINEAR = (0, -4, 0, 0)         # piecewise 0
TWO_PIECE = (-4, -2, -24, -1)  # piecewise 2

# (mode, gaps, W, pair lengths, error rate, seed)
CASES = [
    (MODE_GLOBAL, LINEAR, 1, (90, 120, 150), 0.12, 1),
    (MODE_GLOBAL, AFFINE, 2, (90, 160, 220), 0.12, 2),
    (MODE_GLOBAL, TWO_PIECE, 8, (120, 200, 250), 0.12, 3),
    (MODE_OVERLAP, LINEAR, 2, (100, 150, 200), 0.12, 4),
    (MODE_OVERLAP, AFFINE, 8, (150, 200, 240), 0.12, 5),
    (MODE_OVERLAP, TWO_PIECE, 1, (90, 110, 130), 0.12, 6),
    (MODE_EXTEND, LINEAR, 8, (120, 180, 240), 0.12, 7),
    (MODE_EXTEND, AFFINE, 1, (90, 100, 120), 0.12, 8),
    (MODE_EXTEND, TWO_PIECE, 2, (100, 160, 200), 0.12, 9),
    (MODE_GLOBAL, AFFINE, 8, (150, 200, 250, 300), 0.25, 10),
    (MODE_OVERLAP, AFFINE, 2, (90, 140, 180), 0.25, 11),
    (MODE_EXTEND, LINEAR, 2, (100, 130, 170), 0.25, 12),
]
NT_MAX, NT_MIN = 2, -6


def _operands(mode, gaps, W, lens, err, seed):
    rng = np.random.default_rng(seed)
    qs, ts = zip(*(gen_pair(rng, L, err) for L in lens))
    bw = W * 16
    mtx = JO.set_score_matrix(NT_MAX, NT_MIN)
    pw = JO.get_piecewise(*gaps, bw)
    qpad, qlens, tpad, tlens, rby, T = JP._pack_batch(qs, ts, bw)
    us, es, q0, ub, init = JP._init_state(mode, bw, pw, NT_MAX, NT_MIN,
                                          *gaps, len(qs))
    args = (qpad, qlens, tpad, tlens, JP._mtx5(mtx), rby, us, es, q0, ub)
    return qs, ts, mtx, pw, T, tlens, init, args


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_forward_matches_jax(case):
    mode, gaps, W, lens, err, seed = CASES[case]
    _, _, _, pw, T, tlens, _, args = _operands(*CASES[case])
    rj = KJ.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN)(*args)
    rt = K.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN,
                        codes=False, device="cpu")(*args)
    for b, tl in enumerate(tlens):
        for fld in ("us", "es", "qs", "ubegs", "begs"):
            a, c = getattr(rj.planes, fld), getattr(rt.planes, fld)
            assert (a is None) == (c is None), fld
            if a is not None:
                np.testing.assert_array_equal(
                    np.asarray(a)[:tl, ..., b], c.numpy()[:tl, ..., b],
                    err_msg=f"{fld} pair {b}")
    for fld in ("score", "qe", "te", "final_us", "final_ubegs",
                "final_rbeg"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rj, fld)),
            np.asarray(getattr(rt, fld)).astype(np.asarray(
                getattr(rj, fld)).dtype), err_msg=fld)


@pytest.mark.parametrize("case", [0, 4, 7, 10])
def test_plain_codes_match_extractor(case):
    """Codes emitted by the plain forward == codes_from_rows on its rows."""
    mode, gaps, W, lens, err, seed = CASES[case]
    qs, ts, mtx, pw, T, tlens, init, args = _operands(*CASES[case])
    rt = K.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN,
                        codes=False, device="cpu")(*args)
    rc = K.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN,
                        codes=True, device="cpu")(*args)
    np.testing.assert_array_equal(rt.planes.begs.numpy(),
                                  rc.planes.begs.numpy())
    us, es = rt.planes.us.numpy(), rt.planes.es
    ub = rt.planes.ubegs.numpy()
    for b, tl in enumerate(tlens):
        rows = []
        for i in range(tl):
            st = JO.RowState.__new__(JO.RowState)
            st.us = us[i, :, b].reshape(W, 16)
            st.es = None if es is None else es.numpy()[i, :, b].reshape(W, 16)
            st.qs = None
            st.ubegs = ub[i, :, b].astype(np.int64)
            rows.append(st)
        begs = [int(x) for x in rt.planes.begs.numpy()[:tl, b]]
        want = BC.codes_from_rows(qs[b], ts[b], init, rows, begs, mode,
                                  W * 16, mtx, *gaps)
        got = BC.unpack_codes(rc.planes.codes.numpy()[:tl, :, :, b], W)
        np.testing.assert_array_equal(want, got, err_msg=f"pair {b}")
        # rows past tlen: no codes, frozen band
        assert not rc.planes.codes.numpy()[tl:, ..., b].any()


def _reset_operands(pw, gaps):
    """Global pairs with qlen >> tlen at band 16: the diagonal steering asks
    for a move past the band on row 1, so the band is fully reset."""
    rng = np.random.default_rng(21)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (800, 900, 700)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
    mtx = JO.set_score_matrix(NT_MAX, NT_MIN)
    qpad, qlens, tpad, tlens, rby, T = JP._pack_batch(qs, ts, 16)
    us, es, q0, ub, _ = JP._init_state(MODE_GLOBAL, 16, pw, NT_MAX, NT_MIN,
                                       *gaps, len(qs))
    return T, tlens, (qpad, qlens, tpad, tlens, JP._mtx5(mtx), rby, us, es,
                      q0, ub)


@pytest.mark.parametrize("gaps", [AFFINE, LINEAR])
def test_full_band_reset_matches_jax(gaps):
    pw = JO.get_piecewise(*gaps, 16)
    T, tlens, args = _reset_operands(pw, gaps)
    rj = KJ.make_forward(T, 1, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN)(*args)
    rt = K.make_forward(T, 1, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN,
                        codes=False, device="cpu")(*args)
    rc = K.make_forward(T, 1, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN,
                        codes=True, device="cpu")(*args)
    begs = rt.planes.begs.numpy()
    for b, tl in enumerate(tlens):
        assert np.diff(begs[:tl, b], prepend=0).max() >= 16   # a reset ran
        for fld in ("us", "es", "ubegs", "begs"):
            a = getattr(rj.planes, fld)
            if a is not None:
                np.testing.assert_array_equal(
                    np.asarray(a)[:tl, ..., b],
                    getattr(rt.planes, fld).numpy()[:tl, ..., b])
    np.testing.assert_array_equal(begs, rc.planes.begs.numpy())
    np.testing.assert_array_equal(np.asarray(rj.score), rt.score.numpy())
    np.testing.assert_array_equal(rt.score.numpy(), rc.score.numpy())


def test_fpen_wraps_like_jax():
    """The active F-loop's int8 wrap on stores (bsalign.h:2639-2652)."""
    rng = np.random.default_rng(5)
    B, W, gape = 64, 8, -2
    f = rng.integers(-128, 128, (16, B)).astype(np.int32)
    ub = np.cumsum(rng.integers(-400, 50, (17, B)), axis=0).astype(np.int32)
    want = np.asarray(KJ._fpen(jnp.asarray(f), jnp.asarray(ub), gape, W))
    got = K._fpen(torch.from_numpy(f), torch.from_numpy(ub), gape, W)
    np.testing.assert_array_equal(want, got.numpy())
    s = W * gape + got.numpy()[:-1] - (ub[1:16] - ub[:15])
    assert ((f[:15] < s) & (s > 127)).any()     # the wrap path ran


@pytest.mark.parametrize("gaps", [LINEAR, (-60, -10, 0, 0), TWO_PIECE])
def test_movx_matches_jax(gaps):
    """Band move at every kind of offset: none, inside a stripe, across
    lanes, just short of the band and the full reset past it; the overhang
    constants include C_OH's int8 wrap for (-60, -10)."""
    rng = np.random.default_rng(6)
    W = 4
    BW = W * 16
    movx = np.array([0, 1, 3, W - 1, W, W + 1, 2 * W + 3, 7 * W + 2, BW - 1,
                     BW, BW + 7, 5], np.int32)
    B = len(movx)
    pw = JO.get_piecewise(*gaps, BW)
    us, es, qs = (rng.integers(-20, 20, (W, 16, B)).astype(np.int32)
                  for _ in range(3))
    ub = np.cumsum(rng.integers(-30, 30, (17, B)), axis=0).astype(np.int32)
    es = es if pw >= 1 else None
    qs = qs if pw == 2 else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    want = KJ._movx(j(us), j(es), j(qs), j(ub), j(movx), pw, NT_MAX, NT_MIN,
                    *gaps, W)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    g = K.Geometry(1, W, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN, "planes")
    got = K._movx(t(us), t(es), t(qs), t(ub), t(movx), g)
    for a, c in zip(want, got):
        assert (a is None) == (c is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), c.numpy())


def test_plain_codes_match_pallas_interpret():
    """4 pairs x 90 bp, band 32 (the size of test_kernel_smoke.py)."""
    mode, gaps, W = MODE_GLOBAL, AFFINE, 2
    qs, ts, mtx, pw, T, tlens, _, args = _operands(
        mode, gaps, W, (90, 90, 90, 90), 0.12, 3)
    rp = KP.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, BL=8, Rs=8,
                         codes=True, defer=False, interpret=True)(*args)
    rc = K.make_forward(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, codes=True,
                        device="cpu")(*args)
    for b, tl in enumerate(tlens):
        np.testing.assert_array_equal(rp.planes.codes[:tl, ..., b],
                                      rc.planes.codes.numpy()[:tl, ..., b])
        np.testing.assert_array_equal(rp.planes.begs[:tl, b],
                                      rc.planes.begs.numpy()[:tl, b])
    np.testing.assert_array_equal(np.asarray(rp.score), rc.score.numpy())



def _short_operands(mode, gaps, seed):
    """Three pairs of 24-48 bp at band 32, T = the longest target (no
    rounding), so that a plain run stays short."""
    rng = np.random.default_rng(seed)
    qs, ts = zip(*(gen_pair(rng, L, 0.15) for L in (24, 40, 48)))
    pw = JO.get_piecewise(*gaps, 32)
    qpad, qlens, tpad, tlens, rby, _ = JP._pack_batch(qs, ts, 32)
    us, es, q0, ub, _ = JP._init_state(mode, 32, pw, NT_MAX, NT_MIN, *gaps,
                                       len(qs))
    mtx5 = JP._mtx5(JO.set_score_matrix(NT_MAX, NT_MIN))
    return pw, int(tlens.max()), tlens, (qpad, qlens, tpad, tlens, mtx5, rby,
                                         us, es, q0, ub)


def _kw(emit):
    return dict(codes=emit == "codes", scores_only=emit == "none")


RESUME_CASES = [(emit, gaps, mode) for emit in K.EMITS
                for gaps in (LINEAR, AFFINE, TWO_PIECE)
                for mode in (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND)
                if not (emit == "codes" and gaps == TWO_PIECE)]


@pytest.mark.parametrize("case", range(len(RESUME_CASES)))
def test_plain_resumed_chunks_match_one_shot(case):
    """2-4 row chunks, each resumed from the previous call's final planes,
    anchors and registers at its global row, give the one-shot run's rows
    and final state. The 24 bp pair ends inside an earlier chunk."""
    emit, gaps, mode = RESUME_CASES[case]
    pw, T, _, args = _short_operands(mode, gaps, 40 + case)
    tc = (16, 24, 12)[case % 3]               # 3, 2 and 4 chunks of T = 48
    geom = (2, mode, pw, *gaps, NT_MAX, NT_MIN)
    one = K.make_forward(T, *geom, device="cpu", **_kw(emit))(*args)
    (qpad, qlens, tpad, tlens, mtx5, rby), state = args[:6], list(args[6:])
    reg, parts = None, []
    for c0 in range(0, T, tc):
        c1 = min(c0 + tc, T)
        r = K.make_forward(c1 - c0, *geom, device="cpu", **_kw(emit))(
            qpad, qlens, tpad[:, c0:c1], tlens, mtx5, rby[c0:c1], *state,
            init_reg=reg, row0=c0)
        parts.append(r.planes)
        state = (r.final_planes + [None, None])[:3] + [r.final_ubegs]
        reg = r.final_reg
    assert 2 <= len(parts) <= 4 and tlens.min() <= T - tc
    for fld in K.RowPlanes._fields:
        a = getattr(one.planes, fld)
        got = [getattr(p, fld) for p in parts]
        assert (a is None) == (got[0] is None), fld
        if a is not None:
            assert torch.equal(a, torch.cat(got, 0)), fld
    for fld in ("score", "qe", "te", "final_us", "final_ubegs", "final_rbeg",
                "final_reg"):
        assert torch.equal(getattr(one, fld), getattr(r, fld)), fld
    for a, c in zip(one.final_planes, r.final_planes):
        assert torch.equal(a, c)


@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
@pytest.mark.parametrize("gaps", [LINEAR, AFFINE, TWO_PIECE])
def test_scores_only_matches_planes_and_codes(gaps, mode):
    """The none emit has no per-row outputs and the planes emit's score,
    end cell and final state (and the codes emit's, where it exists);
    planes rows at and past tlen are 0 and begs repeat the frozen rbeg."""
    pw, T, tlens, args = _short_operands(mode, gaps, 60 + mode)
    geom = (T, 2, mode, pw, *gaps, NT_MAX, NT_MIN)
    runs = {e: K.make_forward(*geom, device="cpu", **_kw(e))(*args)
            for e in K.EMITS if not (e == "codes" and pw == 2)}
    none = runs["none"]
    assert all(getattr(none.planes, f) is None for f in K.RowPlanes._fields)
    for e, r in runs.items():
        for fld in ("score", "qe", "te", "final_us", "final_ubegs",
                    "final_reg"):
            assert torch.equal(getattr(r, fld), getattr(none, fld)), (e, fld)
    pl = runs["planes"].planes
    for b, tl in enumerate(tlens):
        for fld in ("us", "es", "qs", "ubegs"):
            a = getattr(pl, fld)
            if a is not None:
                assert not a[tl:, ..., b].any(), fld
        assert (pl.begs[tl:, b] == none.final_rbeg[b]).all()


def test_query_bytes_packing():
    """The CUDA kernel's query operand: uint8, QP rounded up to 16 plus 16
    bytes, the codes of qpad with 4 at and past each pair's qlen and past
    QP, and codes above 4 as 4 (all of those score MIN8)."""
    rng = np.random.default_rng(70)
    lens = (37, 40, 41, 3)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in lens]
    qpad, qlens, *_ = JP._pack_batch(qs, qs, 16)
    QP = qpad.shape[1]
    qpad_t = torch.as_tensor(qpad)
    qpad_t[1, 5] = 7
    qb = K.query_bytes(qpad_t)
    assert qb.dtype == torch.uint8
    assert tuple(qb.shape) == (len(lens), -(-QP // 16) * 16 + 16)
    assert qb.shape[1] % 16 == 0 and qb.shape[1] >= QP + 16
    expect = qpad_t.clamp(max=4).numpy()
    np.testing.assert_array_equal(qb[:, :QP].numpy(), expect)
    assert int(qb[1, 5]) == 4
    for b, L in enumerate(lens):
        np.testing.assert_array_equal(qb[b, :L].numpy(), qs[b] if b != 1
                                      else expect[1, :L])
        assert (qb[b, L:] == 4).all()
