"""The port's edit path against bsalign_tpu's, on the CPU.

(i) The plain PyTorch edit forward against bsalign_tpu.ops.edit_jax on the
same operands: rows below each pair's tlen of pm, pp and sbeg, and smin,
ry, final_score and final_sbeg whole (rows past tlen are not defined).
(ii) The drivers `edit_batch`, `kmer_edit_batch` and `epi2_edit_batch`
against bsalign_tpu.align.editdist: every AlnResult field and the CIGARs.
(iii) `bsalign_tpu_torch.cli edit --device cpu` against `bsalign_tpu.cli
edit`: the same bytes on stdout.

The JAX side runs its XLA engine (BSA_FORWARD_ENGINE=jax), never the
Pallas edit kernel. Every comparison is exact: all values are integers.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu.align import editdist as JE
from bsalign_tpu.ops import edit_jax as KJ
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.align import editdist as TE
from bsalign_tpu_torch.constants import (MODE_EXTEND, MODE_GLOBAL,
                                         MODE_OVERLAP, roundup)
from bsalign_tpu_torch.ops import edit as KE

from .test_torch_align import _jax_cli
from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

T = 256


@pytest.fixture(autouse=True)
def _xla_engine(monkeypatch):
    monkeypatch.setenv("BSA_FORWARD_ENGINE", "jax")


def _operands(qs, ts, bw, banded):
    """The JAX driver's operands, with its NWQ rounding (the JAX engine's
    chunked window needs NWQ % C == 0)."""
    NW = bw // 32
    qlens = np.array([len(q) for q in qs], np.int32)
    tlens = np.array([len(t) for t in ts], np.int32)
    C = 1
    while C < NW + 1:
        C *= 2
    need = max(-(-(int(qlens.max()) + 1) // 32), NW + 1)
    NWQ = roundup(need + NW + 1, C)
    tpad = np.zeros((len(ts), T), np.int32)
    rbegs = np.zeros((T, len(ts)), np.int32)
    movxs = np.zeros((T, len(ts)), np.int32)
    for b, (q, t) in enumerate(zip(qs, ts)):
        tpad[b, :len(t)] = t
        rbegs[:, b], movxs[:, b] = TE._band_trajectory(len(q), len(t), bw,
                                                       banded, T)
    return NWQ, (TE._qeq_planes(qs, NWQ), qlens, tpad, tlens, rbegs, movxs)


def _pairs(lens, err, seed):
    rng = np.random.default_rng(seed)
    return [list(x) for x in zip(*(gen_pair(rng, L, err) for L in lens))]


def _carry_pairs(n):
    """An identical pair and a pair of one repeated base: long runs of
    all-ones words, so the addition's carry crosses several words."""
    rng = np.random.default_rng(9)
    same = rng.integers(0, 4, n).astype(np.uint8)
    return [same, np.full(n - 10, 2, np.uint8)], \
        [same.copy(), np.full(n, 2, np.uint8)]


# (mode, band bits, banded, pairs): banded NW 2 and 3, full band NW 3 and 9
FWD_CASES = {
    "global_banded_nw2": (MODE_GLOBAL, 64, True,
                          lambda: _pairs((150, 200, 240), 0.12, 1)),
    "global_banded_nw3": (MODE_GLOBAL, 96, True,
                          lambda: _pairs((180, 250), 0.15, 2)),
    "global_full_nw3": (MODE_GLOBAL, 96, False,
                        lambda: _pairs((60, 90, 80), 0.12, 3)),
    "global_full_nw9_carry": (MODE_GLOBAL, 288, False,
                              lambda: _carry_pairs(250)),
    "overlap_full_nw9": (MODE_OVERLAP, 288, False,
                         lambda: _pairs((200, 250, 120), 0.12, 4)),
    "extend_full_nw9": (MODE_EXTEND, 288, False,
                        lambda: _pairs((200, 250, 120), 0.12, 5)),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_matches_edit_jax(case):
    mode, bw, banded, make = FWD_CASES[case]
    qs, ts = make()
    NWQ, ops = _operands(qs, ts, bw, banded)
    want = KJ.make_edit_forward(T, bw // 32, mode, NWQ, banded)(*ops)
    got = KE.make_edit_forward(T, bw // 32, mode, NWQ, banded,
                               device="cpu")(*ops)
    assert got.pm.dtype == np.uint32 and got.pm.shape == want.pm.shape
    for b, t in enumerate(ts):
        n = len(t)
        for fld in ("pm", "pp"):
            np.testing.assert_array_equal(getattr(got, fld)[:n, :, b],
                                          np.asarray(getattr(want, fld))[:n, :, b])
        np.testing.assert_array_equal(got.sbeg[:n, b],
                                      np.asarray(want.sbeg)[:n, b])
    for fld in ("smin", "ry", "final_score", "final_sbeg"):
        np.testing.assert_array_equal(getattr(got, fld),
                                      np.asarray(getattr(want, fld)), fld)


def _driver_pairs():
    rng = np.random.default_rng(21)
    pairs = [gen_pair(rng, L, 0.12) for L in (120, 170, 230)]
    pairs.append(gen_pair(rng, 200, 0.25))
    pairs.append((np.zeros(0, np.uint8), pairs[0][1]))     # empty query
    pairs.append((pairs[1][0], np.zeros(0, np.uint8)))     # empty target
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _same(got, want):
    assert len(got) == len(want)
    for (rs, cg), (rj, cj) in zip(got, want):
        assert vars(rs) == vars(rj)
        assert cg == cj


@pytest.mark.parametrize("mode,band", [(MODE_GLOBAL, 0), (MODE_GLOBAL, 64),
                                       (MODE_OVERLAP, 0), (MODE_EXTEND, 0)])
def test_edit_batch_matches_jax(mode, band):
    qs, ts = _driver_pairs()
    _same(TE.edit_batch(qs, ts, mode, band, device="cpu"),
          JE.edit_batch(qs, ts, mode, band))


def test_kmer_edit_batch_matches_jax():
    qs, ts = _driver_pairs()
    rng = np.random.default_rng(22)
    q, t = gen_pair(rng, 600, 0.08)
    qs.append(q)
    ts.append(t)
    _same(TE.kmer_edit_batch(13, qs, ts, device="cpu"),
          JE.kmer_edit_batch(13, qs, ts))


def test_epi2_edit_batch_matches_jax():
    qs, ts = _driver_pairs()
    _same(TE.epi2_edit_batch(qs, ts, device="cpu"),
          JE.epi2_edit_batch(qs, ts))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(31)
    pairs = [gen_pair(rng, L, 0.12) for L in (140, 190, 230)]
    pairs.append(gen_pair(rng, 210, 0.25))
    path = tmp_path_factory.mktemp("torch_edit") / "pairs.fa"
    write_pairs_fasta(str(path), pairs)
    return str(path)


@pytest.mark.parametrize("band", ["0", "64", "128"])
@pytest.mark.parametrize("mode", ["global", "overlap", "extend", "kmer"])
def test_edit_stdout_matches_jax_cli(fasta, mode, band, capsys):
    argv = ["edit", "-m", mode, "-W", band, fasta]
    want = _jax_cli(argv)
    want_err = capsys.readouterr().err
    assert want.count("\n") == 4 * 4
    assert TCLI.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want
    warn = " ** disable band in bsalign-edit's overlap mode ** \n"
    if mode == "overlap" and band != "0":
        assert got.err == warn and warn in want_err
    else:
        assert got.err == ""
