"""The port's pedit profile DP (bsalign_tpu_torch/ops/pedit.py) on the CPU.

The plain PyTorch forward against the host's bsa_pedit_forward (the port's
own copy of rowops.cpp) on random jobs at bw 32, 64 and 128, on the jobs of
real POA windows (including windows whose mlen + bw is not a multiple of
16, where each job carries the previous read's stale T-plane tail), and on
the shortest jobs; then one small batch against the JAX package's Pallas
kernel in interpret mode. Rows [2*mbeg, 2*mend) of both matrices are
compared, and the rest must stay zero. Tolerance 0: the DP is integer.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch.native import rowops as NR
from bsalign_tpu_torch.ops import pedit as PE
from bsalign_tpu_torch.poa.core import BSPOA, BSPOAPar, _remsa_stale_start

torch.set_num_threads(1)
BASES = "ACGT"


def _mk_job(rng, mlen, bw, span=None):
    """A random job laid out as the engine lays out its buffers."""
    HW = bw // 2
    pad = mlen + bw
    seqs0 = np.full(pad, 4, np.uint8)
    seqs1 = np.zeros(pad, np.uint8)
    npos = rng.integers(mlen // 2, mlen)
    pos = np.sort(rng.choice(mlen, npos, replace=False))
    seqs0[HW + pos] = rng.integers(0, 4, npos)
    seqs1[HW:HW + mlen] = rng.integers(0, 5, mlen)
    mats0 = np.zeros((4, pad), np.uint8)
    mats1 = np.zeros((4, pad), np.uint8)
    mats0[:, HW:HW + mlen] = rng.integers(0, 6, (4, mlen))
    # counts up to 250 reach the min(xs + ys, 255) saturation
    mats1[:, HW:HW + mlen] = rng.integers(0, 251, (4, mlen))
    if span is None:
        mbeg = int(rng.integers(0, mlen // 4))
        mend = int(rng.integers(mbeg + 2, mlen + 1))
    else:
        mbeg = int(rng.integers(0, mlen - span + 1))
        mend = mbeg + span
    return PE.PeditJob(seqs0, seqs1, mats0, mats1, mlen, mbeg, mend, bw, HW)


def _native(j):
    rowlen = j.bw + 2
    n0 = np.zeros((2 * j.mlen + 2) * rowlen, np.uint8)
    n1 = np.zeros_like(n0)
    NR.pedit_forward(n0, n1, j.seqs0, j.seqs1, j.mats0, j.mats1, j.mlen,
                     j.mbeg, j.mend, j.bw, j.HW, rowlen)
    return n0, n1


def _assert_same(jobs, outs, refs):
    for k, (j, (m0, m1), (n0, n1)) in enumerate(zip(jobs, outs, refs)):
        rowlen = j.bw + 2
        assert m0.shape == m1.shape == ((2 * j.mlen + 2) * rowlen,)
        lo = 2 * j.mbeg * rowlen
        hi = 2 * max(j.mend, j.mbeg + 1) * rowlen
        for m, n in ((m0, n0), (m1, n1)):
            assert np.array_equal(m[lo:hi], n[lo:hi]), f"job {k}"
            assert not m[:lo].any() and not m[hi:].any(), f"job {k}"


@pytest.mark.parametrize("bw", [32, 64, 128])
def test_plain_vs_native_random(bw):
    rng = np.random.default_rng(bw)
    jobs = [_mk_job(rng, int(rng.integers(20, 160)), bw) for _ in range(6)]
    outs = PE.pedit_forward_batch(jobs, device="cpu")
    _assert_same(jobs, outs, [_native(j) for j in jobs])
    assert PE.last_timings["njobs"] == 6


def test_plain_vs_native_shortest_jobs():
    """mend = mbeg + 2 (three steps) and mend = mbeg + 1 (one step)."""
    rng = np.random.default_rng(5)
    jobs = [_mk_job(rng, int(rng.integers(8, 60)), 32, span=s)
            for s in (2, 1, 2, 1)]
    outs = PE.pedit_forward_batch(jobs, device="cpu")
    _assert_same(jobs, outs, [_native(j) for j in jobs])


def _gen_window(rng, nreads, reflen, err=0.12):
    ref = rng.integers(0, 4, reflen)
    reads = []
    for _ in range(nreads):
        out, i = [], 0
        while i < reflen:
            r = rng.random()
            if r < err * 0.3:
                out.append((int(ref[i]) + int(rng.integers(1, 4))) & 3)
                i += 1
            elif r < err * 0.6:
                out.append(int(rng.integers(0, 4)))
            elif r < err:
                i += 1
            else:
                out.append(int(ref[i]))
                i += 1
        reads.append("".join(BASES[c] for c in out))
    return reads


def _round_jobs(reads):
    """The first realignment round's jobs of one window (all_ = 1)."""
    g = BSPOA(BSPOAPar(), device="cpu")
    g.beg()
    for s in reads:
        g.push(s)
    assert g.end_begin()
    g.msa()
    g.cns_call()
    ctx = g._remsa_prepare(g.par.editbw // 2, 1)
    jobs, _ = g._remsa_dev_build(ctx, 1)
    return jobs, ctx


def test_plain_vs_native_real_windows():
    rng = np.random.default_rng(21)
    stale_seen = False
    for reflen in (150, 173):
        jobs, ctx = _round_jobs(_gen_window(rng, 6, reflen))
        pad = ctx["pad"]
        if pad % 16:
            # the T plane's tail past the stale start carries from read to
            # read; jobs keep their own copies
            s0 = _remsa_stale_start(pad)
            assert s0 < pad
            stale_seen |= any(j.mats0[3, s0:].any() for j in jobs[1:])
            assert len({id(j.mats0) for j in jobs}) == len(jobs)
        assert len({id(j.seqs1) for j in jobs}) == 1
        outs = PE.pedit_forward_batch(jobs, device="cpu")
        _assert_same(jobs, outs, [_native(j) for j in jobs])
    assert stale_seen


def test_plain_vs_pallas_interpret():
    from bsalign_tpu.ops import pedit_pallas as PP
    rng = np.random.default_rng(8)
    jobs = [_mk_job(rng, int(rng.integers(40, 120)), 64) for _ in range(4)]
    jj = [PP.PeditJob(j.seqs0, j.seqs1, j.mats0, j.mats1, j.mlen, j.mbeg,
                      j.mend, j.bw, j.HW) for j in jobs]
    ref = PP.pedit_forward_batch(jj, Rs=16, interpret=True)
    outs = PE.pedit_forward_batch(jobs, device="cpu")
    _assert_same(jobs, outs, ref)


def test_counts_layout_plain_vs_native_shared_window():
    """The packed layout (bases, and the four counts of a position in one
    word) on a batch whose jobs share a window's consensus side and sit at
    other offsets than 0: the plain version equals bsa_pedit_forward."""
    rng = np.random.default_rng(13)
    a = _mk_job(rng, 90, 32)
    jobs = [a, PE.PeditJob(a.seqs0.copy(), a.seqs1, a.mats0.copy(), a.mats1,
                           90, 5, 70, 32, 16), _mk_job(rng, 61, 32), a]
    pk = PE.pack_jobs(jobs, "cpu")
    assert pk.cn.numel() == (90 + 32) + (61 + 32)   # two windows
    outs = PE.pedit_forward_batch(jobs, device="cpu")
    _assert_same(jobs, outs, [_native(j) for j in jobs])


def test_pack_shares_window_planes():
    rng = np.random.default_rng(3)
    a = _mk_job(rng, 50, 32)
    b = PE.PeditJob(a.seqs0.copy(), a.seqs1, a.mats0.copy(), a.mats1, 50,
                    3, 40, 32, 16)
    c = _mk_job(rng, 70, 32)
    pk = PE.pack_jobs([a, b, c], "cpu")
    pad = np.array([82, 82, 102])
    assert pk.rd.numel() == pad.sum() and pk.rdm.numel() == 4 * pad.sum()
    assert pk.cn.numel() == 82 + 102 and pk.cnm.numel() == 4 * (82 + 102)
    assert pk.jobs[:, PE.JOB_CN].tolist() == [0, 0, 82]
    # counts interleaved by position, at 4 x the base planes' offsets
    assert np.array_equal(pk.rdm[:4 * 82].view(82, 4).T.numpy(), a.mats0)
    assert np.array_equal(pk.cnm[4 * 82:].view(102, 4).T.numpy(), c.mats1)
    assert np.array_equal(pk.rd[2 * 82:].numpy(), c.seqs0)
    assert pk.total == 2 * (2 * 50 + 2) * 34 + (2 * 70 + 2) * 34
