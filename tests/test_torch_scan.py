"""A CPU model of kernel A's wide row (csrc/banded8_wide.cu) in numpy, held
bit for bit against the plain row (bsalign_tpu_torch.ops.banded8._row_cal)
and the plain forward.

The wide kernel cuts each lane's chain of W stripes into runs of R stripes
(`_cuda.wide_geometry`), one thread a run. Each run composes its stripes'
f (and g) steps into one max-plus affine map: f -> max(f + a, b) at
piecewise 0/1, and at piecewise 2 a 2x2 max-plus matrix with a constant on
(f, g), since g's step reads f through h. The upper clamp at 127 is
dropped from the maps, so they compose exactly. An exclusive scan of the
maps along the lane proposes each run's entering f (and g); each run then
runs the serial saturating step from its proposal, and the boundary check
(run k's exit equals run k + 1's proposal) proves the row, by induction over
the runs. A pair whose check fails anywhere replays the row's chain lane by
lane. The model follows that order in both passes, with pass 2's first
stripe of each run taking the run before's last v afterwards.

- the model's forward (the plain forward with its row through the model)
  against the plain forward at W 16, 40 and 64 and K 2, 4 and 8, for
  piecewise 0/1/2 x global/overlap/extend x every emit;
- random and adversarial rows (u, e, q and the query scores drawn so that
  f and g reach the clamp at 127): the check flags a pass exactly where
  some proposal differs from the serial chain's value, the replayed row
  equals the plain row, and the adversarial rows do replay;
- the run geometry the launcher gives the kernel.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.ops import _cuda
from bsalign_tpu_torch.ops import banded8 as K
from bsalign_tpu_torch.oracle import banded8 as O

from .util import gen_pair

torch.set_num_threads(1)

MIN8 = K.MIN8
NEG = -(1 << 29)   # the maps' minus infinity: sums of a few stay in int32
WS = 16
NT_MAX, NT_MIN = 2, -6
GAPS = {0: (0, -4, 0, 0), 1: (-3, -2, 0, 0), 2: (-4, -2, -10, -1)}


def sat(x):
    return np.clip(x, -128, 127)


class Costs:
    def __init__(self, g):
        self.E = g.gape1
        self.OE = g.gapo1 + g.gape1
        self.P = g.gape2
        self.QP = g.gapo2 + g.gape2
        self.OQ = max(-128, min(127, self.OE - self.QP))


def cell_m(pw, c, u, e_in, q_in, z):
    """The part of a cell's h that does not depend on f or g."""
    if pw == 0:
        return np.maximum(sat(u + c.E), z)
    m = np.maximum(sat(e_in + u), z)
    return np.maximum(m, sat(q_in + u)) if pw == 2 else m


def step(pw, c, u, m, f, g):
    """One stripe of the serial f (and g) chain, saturating."""
    if pw == 0:
        return sat(sat(np.maximum(m, f) + c.E) - u), g
    h = np.maximum(m, f) if pw == 1 else np.maximum(np.maximum(m, f), g)
    h = sat(h + c.OE)
    f2 = sat(np.maximum(sat(f + c.E), h) - u)
    if pw == 1:
        return f2, g
    return f2, sat(np.maximum(sat(g + c.P), sat(h - c.OQ)) - u)


def step_map(pw, c, u, m):
    """The stripe's step without the upper clamp, as the max-plus map
    (A [2, 2], B [2]) on (f, g): f' = max(f + A00, g + A01, B0)."""
    negs = np.full_like(u, NEG)
    if pw == 0:
        b = np.maximum(np.maximum(m + c.E, -128) - u, -128)
        return [[c.E - u, negs], [negs, np.zeros_like(u)]], [b, negs]
    cm = np.maximum(m + c.OE, -128)
    a00 = max(c.E, c.OE) - u
    b0 = np.maximum(cm - u, -128)
    if pw == 1:
        return [[a00, negs], [negs, np.zeros_like(u)]], [b0, negs]
    a10 = c.OE - c.OQ - u
    a11 = max(c.P, c.OE - c.OQ) - u
    b1 = np.maximum(np.maximum(cm - c.OQ, -128) - u, -128)
    return [[a00, c.OE - u], [a10, a11]], [b0, b1]


def compose(m1, m2):
    """m1, then m2, clamped at NEG."""
    (A1, B1), (A2, B2) = m1, m2
    A = [[np.maximum(np.maximum(A2[i][0] + A1[0][j], A2[i][1] + A1[1][j]),
                     NEG) for j in range(2)] for i in range(2)]
    B = [np.maximum(np.maximum(np.maximum(A2[i][0] + B1[0],
                                          A2[i][1] + B1[1]), B2[i]), NEG)
         for i in range(2)]
    return A, B


def apply(mp, f, g):
    A, B = mp
    return (np.maximum(np.maximum(f + A[0][0], g + A[0][1]), B[0]),
            np.maximum(np.maximum(f + A[1][0], g + A[1][1]), B[1]))


def identity(shape):
    z, n = np.zeros(shape, np.int64), np.full(shape, NEG, np.int64)
    return [[z, n], [n, z]], [n, n]


def row_cal_runs(g, K_, qprof, us0, es0, qs0, ub0, rh):
    """The wide row: _row_cal's arguments and results (torch tensors),
    plus per pair (replayed in pass 1, replayed in pass 2, some pass-1
    proposal wrong, some pass-2 proposal wrong) as numpy bools."""
    pw, W = g.piecewise, g.W
    c = Costs(g)
    R, _ = _cuda.wide_geometry(W, K_)
    runs = [(x0, min(W, x0 + R)) for x0 in range(0, W, R)]
    npy = (lambda t: None if t is None else t.numpy().astype(np.int64))
    qp, u0, e0, q0, ub = map(npy, (qprof, us0, es0, qs0, ub0))
    rh = rh.numpy().astype(np.int64)
    B = u0.shape[-1]
    e0 = np.zeros_like(u0) if e0 is None else e0
    q0 = np.zeros_like(u0) if q0 is None else q0
    # row head (bsalign.h:2520-2540), as _row_cal
    t0 = u0[0, 0] + (c.E if pw == 0 else e0[0, 0] if pw == 1
                     else np.maximum(e0[0, 0], q0[0, 0]))
    h0 = rh - ub[0] + qp[0, 0]
    h0 = np.where(h0 >= t0, np.minimum(h0, K.SCORE_EPI8_MAX), MIN8)
    h0 = ((h0 + 128) & 0xFF) - 128
    z = qp[:W].copy()
    z[0, 0] = h0
    m = cell_m(pw, c, u0, e0, q0, z)
    maps = []
    for x0, x1 in runs:   # each run's map, composed stripe by stripe
        mp = identity((WS, B))
        for x in range(x0, x1):
            mp = compose(mp, step_map(pw, c, u0[x], m[x]))
        maps.append(mp)
    pre = [identity((WS, B))]   # exclusive prefix maps along the lane
    for mp in maps[:-1]:
        pre.append(compose(pre[-1], mp))

    def chain(x0, x1, f, gg):
        for x in range(x0, x1):
            f, gg = step(pw, c, u0[x], m[x], f, gg)
        return f, gg

    def serial_entries(f, gg):
        out = []
        for x0, x1 in runs:
            out.append((f, gg))
            f, gg = chain(x0, x1, f, gg)
        return out, (f, gg)

    def checked(entries):
        """Each run's exit from its entry; the boundary check per pair."""
        exits = [chain(x0, x1, *en) for (x0, x1), en in zip(runs, entries)]
        bad = np.zeros(B, bool)
        for k in range(len(runs) - 1):
            for a, b in zip(exits[k], entries[k + 1]):
                bad |= (a != b).any(0)
        return exits, bad

    def wrong(entries, true):
        bad = np.zeros(B, bool)
        for (a, b), (ta, tb) in zip(entries, true):
            bad |= (a != ta).any(0) | (b != tb).any(0)
        return bad

    # pass 1: every lane enters at MIN8
    minf = np.full((WS, B), MIN8, np.int64)
    prop1 = [apply(p, minf, minf) for p in pre]
    exits, rep1 = checked(prop1)
    true1, end1 = serial_entries(minf, minf)
    fend = [np.where(rep1, t, e) for t, e in zip(end1, exits[-1])]
    # the F-loops over the lane heads, as the plain row
    ubt = torch.from_numpy(ub.astype(np.int32))
    fh = K._fpen(torch.from_numpy(fend[0].astype(np.int32)), ubt, c.E,
                 W).numpy().astype(np.int64)
    gh = K._fpen(torch.from_numpy(fend[1].astype(np.int32)), ubt, c.P,
                 W).numpy().astype(np.int64) if pw == 2 else minf
    # pass 2: the runs enter at (lane head) composed with the prefix map
    prop2 = [apply(p, fh, gh) for p in pre]
    _, rep2 = checked(prop2)
    true2, _ = serial_entries(fh, gh)
    ent2 = [tuple(np.where(rep2, t, p) for t, p in zip(te, pe))
            for te, pe in zip(true2, prop2)]
    us1 = np.zeros((W, WS, B), np.int64)
    es1, qs1 = np.zeros_like(us1), np.zeros_like(us1)
    v_end, h_first, h_l = [], [], None
    for (x0, x1), (f, gg) in zip(runs, ent2):
        v = np.zeros((WS, B), np.int64)   # the run before's v comes later
        for x in range(x0, x1):
            u = u0[x]
            if pw == 0:
                h = np.maximum(m[x], f)
            else:
                e = sat(e0[x] + u)
                h = np.maximum(m[x], f) if pw == 1 \
                    else np.maximum(np.maximum(m[x], f), gg)
                es1[x] = np.maximum(sat(sat(e + c.E) - h), c.OE)
                if pw == 2:
                    qs1[x] = np.maximum(sat(sat(sat(q0[x] + u) + c.P) - h),
                                        c.QP)
            if x == x0:
                h_first.append(h)
            us1[x] = sat(h - v)
            v = sat(h - u)
            f, gg = step(pw, c, u, m[x], f, gg)
            h_l = h if pw == 0 else sat(h + c.OE)
            if pw == 2:
                h_l = sat(h_l - c.OQ)
        v_end.append(v)
    for k, (x0, _) in enumerate(runs[1:], 1):
        us1[x0] = sat(h_first[k] - v_end[k - 1])
    # tail (bsalign.h:2618-2636), as the plain row
    h_fin = h_l if pw == 0 else sat(h_l - (c.OE if pw == 1 else c.QP))
    v2 = sat(h_fin - u0[W - 1])
    v3 = np.concatenate([np.zeros((1, B), np.int64), v2[:-1]], 0)
    us1_0 = sat(us1[0] - v3)
    ub1 = np.concatenate([(ub[0] + us1_0[0])[None], ub[1:] + v2], 0)
    us1_0[0] = 0
    us1[0] = us1_0

    def out(a):
        return torch.from_numpy(a.astype(np.int32))
    flags = (rep1, rep2, wrong(prop1, true1), wrong(prop2, true2))
    return (out(us1), out(es1) if pw >= 1 else None,
            out(qs1) if pw == 2 else None, out(ub1), flags)


def test_wide_geometry():
    # runs of a multiple of 8 stripes, an odd number of 8-byte words,
    # covering the lane with at most K runs
    for W in (1, 7, 8, 9, 16, 40, 64, 100, 128, 256, 1504, 2000, 2048, 7256):
        for K_ in (2, 4, 8, 16, 32):
            R, n = _cuda.wide_geometry(W, K_)
            assert R % 8 == 0 and (R // 8) % 2 == 1
            assert n == -(-W // R) <= K_ and (n - 1) * R < W
    for W in (32, 64, 128, 256, 2000):
        assert _cuda.wide_lanes(W) in (2, 4, 8, 16, 32)
    assert _cuda.wide_lanes(2000) == 32


def _rand_row(rng, pw, W, B, adversarial):
    """Random int8 rows: full range, or drawn so that f and g climb to the
    clamp at 127 (strongly negative u, high e, q and query scores)."""
    if adversarial:
        u = rng.integers(-128, -60, (W, WS, B))
        e = rng.integers(20, 128, (W, WS, B))
        q = rng.integers(20, 128, (W, WS, B))
        qp = rng.integers(0, 128, (W + 1, WS, B))
    else:
        u = rng.integers(-128, 128, (W, WS, B))
        e = rng.integers(-128, 128, (W, WS, B))
        q = rng.integers(-128, 128, (W, WS, B))
        qp = rng.integers(-128, 128, (W + 1, WS, B))
    ub = np.cumsum(rng.integers(-40, 40, (WS + 1, B)), 0)
    rh = rng.integers(-200, 200, B)
    t = (lambda a: torch.from_numpy(a.astype(np.int32)))
    return (t(qp), t(u), t(e) if pw >= 1 else None, t(q) if pw == 2 else None,
            t(ub), t(rh))


@pytest.mark.parametrize("pw", [0, 1, 2])
@pytest.mark.parametrize("adversarial", [False, True])
def test_random_rows_check_and_replay(pw, adversarial):
    rng = np.random.default_rng(100 + 10 * pw + adversarial)
    replays = 0
    for W, K_ in ((16, 2), (40, 4), (64, 8), (40, 2), (64, 4)):
        g = K.Geometry(1, W, MODE_GLOBAL, pw, *GAPS[pw], NT_MAX, NT_MIN,
                       "planes")
        for _ in range(4):
            args = _rand_row(rng, pw, W, 6, adversarial)
            *got, (rep1, rep2, wrong1, wrong2) = row_cal_runs(g, K_, *args)
            want = K._row_cal(g, *args)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b)
            # the check flags a pass where, and only where, a proposal is
            # not the serial chain's value
            np.testing.assert_array_equal(rep1, wrong1)
            np.testing.assert_array_equal(rep2, wrong2)
            replays += int(rep1.sum() + rep2.sum())
    if adversarial:
        assert replays > 0


# (mode, W, K, seed): every mode, W in {16, 40, 64}, K in {2, 4, 8}
FWD = [(MODE_GLOBAL, 16, 2, 1), (MODE_OVERLAP, 40, 4, 2),
       (MODE_EXTEND, 64, 8, 3), (MODE_GLOBAL, 64, 4, 4),
       (MODE_OVERLAP, 16, 8, 5), (MODE_EXTEND, 40, 2, 6)]


# (piecewise, emit): codes cover piecewise 0/1
COMBOS = [(pw, emit) for pw in (0, 1, 2) for emit in K.EMITS
          if not (emit == "codes" and pw == 2)]


@pytest.mark.parametrize("combo", range(len(COMBOS)))
@pytest.mark.parametrize("case", range(len(FWD)))
def test_model_forward_matches_plain(monkeypatch, case, combo):
    pw, emit = COMBOS[combo]
    mode, W, K_, seed = FWD[case]
    rng = np.random.default_rng(seed)
    # queries near the band so that it moves; a short last pair freezes
    lens = (int(W * 16 * 1.2), int(W * 16 * 0.9), W * 8)
    qs, ts = zip(*(gen_pair(rng, L, 0.12) for L in lens))
    bw = W * 16
    mtx = O.set_score_matrix(NT_MAX, NT_MIN)
    gaps = GAPS[pw]
    assert O.get_piecewise(*gaps, bw) == pw
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bw)
    T = min(T, 40)   # a few hundred rows over the parametrised cases
    us, es, q0, ub, _ = P._init_state(mode, bw, pw, NT_MAX, NT_MIN, *gaps,
                                      len(qs))
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, emit)
    st = K.state_from_numpy(qpad, qlens, tpad, tlens, P._mtx5(mtx), rby, us,
                            es, q0, ub, T=T, device="cpu")
    want = K.forward_plain(g, st)
    plain = K._row_cal
    monkeypatch.setattr(K, "_row_cal", lambda *a: row_cal_runs(
        a[0], K_, *a[1:])[:4])
    got = K.forward_plain(g, st)
    monkeypatch.setattr(K, "_row_cal", plain)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], want[k]
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), k


def test_launcher_refuses_unknown_design_and_cpu_tensors():
    """The launcher takes "narrow" or "wide" (or None: the wide row from
    WIDE_W on), counts replays of the wide row only, and never runs on
    CPU tensors (the CPU path is the plain forward)."""
    rng = np.random.default_rng(3)
    qs, ts = zip(*(gen_pair(rng, 200, 0.1) for _ in range(2)))
    gaps = GAPS[1]
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, 512)
    us, es, q0, ub, _ = P._init_state(MODE_OVERLAP, 512, 1, NT_MAX, NT_MIN,
                                      *gaps, 2)
    g = K.Geometry(T, 32, MODE_OVERLAP, 1, *gaps, NT_MAX, NT_MIN, "codes")
    st = K.state_from_numpy(qpad, qlens, tpad, tlens,
                            P._mtx5(O.set_score_matrix(NT_MAX, NT_MIN)), rby,
                            us, es, q0, ub, T=T, device="cpu")
    before = (_cuda.launches_codes, _cuda.launches_wide_codes)
    for kw in (dict(design="diagonal"),
               dict(design="narrow", count_replays=True),
               dict(design="wide"), dict()):
        with pytest.raises(ValueError):
            _cuda.banded8_rows(g, st, **kw)
    assert (_cuda.launches_codes, _cuda.launches_wide_codes) == before
