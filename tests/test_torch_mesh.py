"""The port's batch split over devices (parallel/mesh.py), on the CPU.

The sharded forwards of kernels A (banded-8: codes, planes, none, and a
resumed row chunk), B (edit, full band and banded) and C (pedit, one
realignment round of 8 windows) on [cpu] * n must equal the unsharded
forward byte for byte (tolerance 0: integer outputs), for batches that
divide evenly and batches that do not (shards one pair apart, and shards
left empty). The sharded banded-8 scores are also held against the JAX
package's sharded XLA forward (bsalign_tpu.parallel.mesh) on the same
seeded pairs, over two of its virtual CPU devices.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch.align import editdist as ED
from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.ops import banded8 as K8
from bsalign_tpu_torch.ops import edit as KE
from bsalign_tpu_torch.ops import pedit as PE
from bsalign_tpu_torch.oracle import banded8 as O
from bsalign_tpu_torch.parallel import mesh as M

from .test_torch_pedit import _gen_window, _round_jobs

torch.set_num_threads(1)

CPU = torch.device("cpu")
AFF, ONT = (-3, -2, 0, 0), (-4, -2, -24, -1)


def _pairs(B, L, seed):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(B):
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        idx = rng.random(L) < 0.1
        q[idx] = (q[idx] + rng.integers(1, 4, int(idx.sum()))) & 3
        q = q[:L - int(rng.integers(0, 9))]
        qs.append(q)
        ts.append(t[:L - int(rng.integers(0, 9))])
    return qs, ts


def _b8_args(qs, ts, bw, mode, gaps, mtx):
    pw = O.get_piecewise(*gaps, bw)
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bw)
    us, es, qs0, ub, _ = P._init_state(mode, bw, pw, int(mtx.max()),
                                       int(mtx.min()), *gaps, len(qs))
    return (qpad, qlens, tpad, tlens, P._mtx5(mtx), rby, us, es, qs0,
            ub), T, pw


def _same(a, b, what):
    """Every field of two results (tensors, arrays, lists or None)."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a.shape == b.shape and torch.equal(a, b), what


# (label, B, n devices, emit, band, mode, gaps)
B8_CASES = [
    ("codes-even", 6, 3, "codes", 32, 0, AFF),
    ("codes-uneven", 5, 3, "codes", 32, 1, AFF),
    ("planes-pw2-uneven", 7, 2, "planes", 32, 0, ONT),
    ("planes-pw0-empty-shard", 2, 3, "planes", 48, 2, (0, -4, 0, 0)),
    ("none-uneven", 5, 4, "none", 32, 1, AFF),
]


@pytest.mark.parametrize("case", B8_CASES, ids=[c[0] for c in B8_CASES])
def test_sharded_banded8_equals_unsharded(case):
    label, B, n, emit, bw, mode, gaps = case
    mtx = O.set_score_matrix(2, -4 if gaps == ONT else -6)
    qs, ts = _pairs(B, 90, 10 + B)
    args, T, pw = _b8_args(qs, ts, bw, mode, gaps, mtx)
    geo = (T, bw // 16, mode, pw, *gaps, int(mtx.max()), int(mtx.min()))
    kw = dict(scores_only=emit == "none", codes=emit == "codes")
    got = M.make_sharded_forward(*geo, [CPU] * n, **kw)(*args)
    want = K8.make_forward(*geo, **kw, device=CPU)(*args)
    for f in K8.ForwardResult._fields:
        _same(getattr(got, f), getattr(want, f), f"{label} {f}")


def test_sharded_banded8_resumes_a_row_chunk():
    """Rows [64, 128) resumed from the unsharded first chunk's final
    planes, anchors and registers ([8, B], split on the batch axis too)."""
    mtx = O.set_score_matrix(2, -6)
    qs, ts = _pairs(5, 120, 3)
    args, T, pw = _b8_args(qs, ts, 32, 0, AFF, mtx)
    qpad, qlens, tpad, tlens, m5, rby = args[:6]
    geo = (64, 2, 0, pw, *AFF, 2, -6)
    first = K8.make_forward(*geo, codes=True, device=CPU)(*args)
    us, es = first.final_planes
    rest = (qpad, qlens, tpad[:, 64:], tlens, m5, rby[64:], us.numpy(),
            es.numpy(), None, first.final_ubegs.numpy())
    reg = first.final_reg.numpy()
    got = M.make_sharded_forward(*geo, [CPU] * 2, codes=True)(
        *rest, init_reg=reg, row0=64)
    want = K8.make_forward(*geo, codes=True, device=CPU)(
        *rest, init_reg=reg, row0=64)
    for f in K8.ForwardResult._fields:
        _same(getattr(got, f), getattr(want, f), f)


def test_sharded_banded8_scores_match_jax_mesh():
    """The port's sharded codes forward and the JAX package's sharded XLA
    forward give the same global scores on the same 6 pairs."""
    import jax
    from bsalign_tpu.parallel import mesh as JM
    mtx = O.set_score_matrix(2, -6)
    qs, ts = _pairs(6, 60, 21)
    args, T, pw = _b8_args(qs, ts, 32, 0, AFF, mtx)
    geo = (T, 2, 0, pw, *AFF, 2, -6)
    got = M.make_sharded_forward(*geo, [CPU] * 3, codes=True)(*args)
    jmesh = JM.make_mesh(jax.devices("cpu")[:2])
    want = JM.make_sharded_forward(*geo, jmesh)(*args)
    assert np.array_equal(got.score.numpy(), np.asarray(want.score))


# (label, B, n devices, band, banded, mode)
EDIT_CASES = [
    ("full-even", 4, 2, 128, False, 0),
    ("full-uneven-overlap", 5, 3, 128, False, 1),
    ("banded-uneven", 7, 3, 64, True, 0),
]


@pytest.mark.parametrize("case", EDIT_CASES, ids=[c[0] for c in EDIT_CASES])
def test_sharded_edit_equals_unsharded(case):
    label, B, n, bw, banded, mode = case
    qs, ts = _pairs(B, 110, 40 + B)
    T, NWQ, ops = ED._pack_bucket(qs, ts, bw, banded)
    got = M.make_sharded_edit_forward(T, bw // 32, mode, NWQ, banded,
                                      [CPU] * n)(*ops)
    want = KE.make_edit_forward(T, bw // 32, mode, NWQ, banded,
                                device=CPU)(*ops)
    for f in KE.EditResult._fields:
        _same(getattr(got, f), getattr(want, f), f"{label} {f}")


def test_sharded_pedit_equals_unsharded():
    """One realignment round of 8 windows: every job's two matrices."""
    rng = np.random.default_rng(31)
    jobs = [j for _ in range(8)
            for j in _round_jobs(_gen_window(rng, 4, 60))[0]]
    assert len(jobs) % 3
    want = PE.pedit_forward_batch(jobs, device=CPU)
    got = M.sharded_pedit_forward(jobs, [CPU] * 3)
    assert len(got) == len(want) == len(jobs)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert np.array_equal(g0, w0) and np.array_equal(g1, w1)


def test_shard_bounds():
    assert M.shard_bounds(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert M.shard_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    for B in (0, 1, 7, 64):
        for n in (1, 2, 3, 8):
            b = M.shard_bounds(B, n)
            assert b[0][0] == 0 and b[-1][1] == B
            assert all(x[1] == y[0] for x, y in zip(b, b[1:]))
            assert max(h - l for l, h in b) - min(h - l for l, h in b) <= 1


def test_dryrun_multichip():
    M.dryrun_multichip(2, [CPU] * 2)


def test_dryrun_refuses_fewer_devices():
    with pytest.raises(RuntimeError, match="need 3 devices"):
        M.dryrun_multichip(3, [CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no devices"):
            M.make_mesh()
