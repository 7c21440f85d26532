"""The byte budget of one launch (LAUNCH_BYTES in align/pairwise.py and
align/editdist.py) on the CPU: with the budget set small, `align` (codes,
the two-pass mode, -Q 24 -P 1 planes) and `edit` (-W 0 global, overlap)
run their pairs in at least two launches, each counted where the forward
is called, and still print the bytes of bsalign_tpu.cli.

The JAX CLI runs with USE_DEVICE = False (its numpy oracle for `align`,
its host C++ for `edit`), whose output its own tests hold to its device
engines; that keeps this file to seconds. Tolerance 0: text.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from bsalign_tpu import cli as JCLI
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.align import editdist as D
from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.ops import banded8 as K8
from bsalign_tpu_torch.ops import edit as KE

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(*args) == 0
    return buf.getvalue()


def _jax_cli(argv, monkeypatch):
    monkeypatch.setattr(JCLI, "USE_DEVICE", False)
    monkeypatch.setattr(sys, "argv", ["bsalign_tpu"] + argv)
    return _stdout(JCLI.main)


def _count(monkeypatch, mod):
    """Count the calls of mod.forward_raw (the kernel or its plain
    version: one launch each)."""
    calls = []
    real = mod.forward_raw
    monkeypatch.setattr(mod, "forward_raw",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(21)
    pairs = [gen_pair(rng, L, 0.12) for L in (150, 190, 230, 250)]
    path = tmp_path_factory.mktemp("torch_wide") / "pairs.fa"
    write_pairs_fasta(str(path), pairs)
    return str(path)


@pytest.fixture(scope="module")
def long_fasta(tmp_path_factory):
    rng = np.random.default_rng(22)
    pairs = [gen_pair(rng, L, 0.12) for L in (330, 370, 400)]
    path = tmp_path_factory.mktemp("torch_wide") / "long.fa"
    write_pairs_fasta(str(path), pairs)
    return str(path)


# (argv, LAUNCH_BYTES): 4 pairs of T = 256 rows at band 64 (W = 4): codes
# take 68 bytes a row and pair, the 2-piece planes 264
ALIGN_CASES = [
    (["-m", "global", "-W", "64"], 40000),
    (["-m", "global", "-W", "64", "-O", "4", "-E", "2", "-Q", "24", "-P",
      "1"], 140000),
]


@pytest.mark.parametrize("case", range(len(ALIGN_CASES)))
def test_align_budget_splits_and_matches_jax(fasta, case, monkeypatch):
    flags, budget = ALIGN_CASES[case]
    want = _jax_cli(["align"] + flags + [fasta], monkeypatch)
    monkeypatch.setattr(P, "LAUNCH_BYTES", budget)
    calls = _count(monkeypatch, K8)
    got = _stdout(TCLI.main, ["align", "--device", "cpu"] + flags + [fasta])
    assert len(calls) == 2
    assert got == want and want.count("\n") == 16


def test_align_two_pass_budget_cuts_rows_and_pairs(long_fasta, monkeypatch):
    """The two-pass mode (T_CHUNK and REALIGN_T 256, T = 512) at a budget
    that fits the 3 pairs neither at 256 rows a chunk (18,632 bytes a pair)
    nor at 128 (11,152): the chunk is halved to 128 rows and the pairs run
    in two groups."""
    flags = ["-m", "overlap", "-W", "64"]
    want = _jax_cli(["align"] + flags + [long_fasta], monkeypatch)
    monkeypatch.setattr(P, "T_CHUNK", 256)
    monkeypatch.setattr(P, "REALIGN_T", 256)
    monkeypatch.setattr(P, "LAUNCH_BYTES", 25000)
    assert P._launch_plan(3, 512, 4, 1, True) == (2, 128)
    groups = []
    real = P._twopass_batch
    monkeypatch.setattr(P, "_twopass_batch",
                        lambda *a: groups.append(a[14]) or real(*a))
    got = _stdout(TCLI.main, ["align", "--device", "cpu"] + flags
                  + [long_fasta])
    assert groups == [128, 128]
    assert got == want and want.count("\n") == 12


@pytest.mark.parametrize("flags", [["-m", "global", "-W", "0"],
                                   ["-m", "overlap"]])
def test_edit_budget_splits_and_matches_jax(fasta, flags, monkeypatch):
    """Band 256 (NW 8) over T = 256 rows: 17,408 bytes of pm, pp and sbeg
    a pair, two pairs a launch."""
    want = _jax_cli(["edit"] + flags + [fasta], monkeypatch)
    monkeypatch.setattr(D, "LAUNCH_BYTES", 40000)
    assert D._launch_pairs(256, 8) == 2
    calls = _count(monkeypatch, KE)
    got = _stdout(TCLI.main, ["edit", "--device", "cpu"] + flags + [fasta])
    assert len(calls) == 2
    assert got == want and want.count("\n") == 16


def test_launch_plan_floor_is_one_pair():
    """A pair larger than the budget still runs, one pair a launch; a batch
    within it runs whole."""
    assert P._launch_plan(4, 1 << 20, 64, 2, False)[0] == 1
    assert P._launch_plan(4, 256, 8, 1, True) == (4, P.T_CHUNK)
    assert D._launch_pairs(1 << 20, 1024) == 1
