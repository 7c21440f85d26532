"""The port's scalar debug path and host helpers against the JAX package's,
on the CPU, with tolerance 0 (integers and text):

- `oracle.banded8.pairwise` (the port's own numpy copy) against
  bsalign_tpu.oracle.banded8.pairwise on seeded 300 bp pairs over the three
  modes, piecewise 0/1/2 and bands 0/32/128;
- the CLI with USE_DEVICE = False (align through that oracle, edit through
  the host C++) against bsalign_tpu.cli with the same patch;
- `cigars_to_str`, `left_tidy_cigars` and `cigar_stats` against
  bsalign_tpu.cigar on the cases of tests/test_cigar_utils.py;
- `poa.batch.run_windows(nproc=2)` on the CPU against the JAX package's
  run_windows(nproc=2), and its refusal of nproc > 1 on a CUDA device.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from bsalign_tpu import cigar as JC
from bsalign_tpu import cli as JCLI
from bsalign_tpu.oracle import banded8 as JO
from bsalign_tpu.poa.batch import run_windows as j_run_windows
from bsalign_tpu.poa.cli import default_poa_par
from bsalign_tpu.seqs import encode_dna
from bsalign_tpu_torch import cigar as TC
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.oracle import banded8 as TO
from bsalign_tpu_torch.poa import batch as PB

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

GAPS = {0: (0, -4, 0, 0), 1: (-3, -2, 0, 0), 2: (-4, -2, -10, -1)}


@pytest.mark.parametrize("band", [0, 32, 128])
@pytest.mark.parametrize("pw", [0, 1, 2])
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
def test_oracle_pairwise_matches_jax(mode, pw, band):
    rng = np.random.default_rng(100 * mode + 10 * pw + band)
    q, t = gen_pair(rng, 300, 0.12)
    mtx = TO.set_score_matrix(2, -4 if pw == 2 else -6)
    gaps = GAPS[pw]
    assert TO.get_piecewise(*gaps, band or len(q)) == pw
    rs, cg = TO.pairwise(q, t, mode, band, mtx, *gaps)
    jrs, jcg = JO.pairwise(q, t, mode, band, np.asarray(mtx), *gaps)
    assert cg == jcg and cg
    assert vars(rs) == vars(jrs)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(*args) == 0
    return buf.getvalue()


def _jax_cli(argv):
    old = sys.argv
    sys.argv = ["bsalign_tpu"] + argv
    try:
        return _stdout(JCLI.main)
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(5)
    pairs = [gen_pair(rng, L, 0.12) for L in (120, 180, 240)]
    path = tmp_path_factory.mktemp("torch_oracle") / "pairs.fa"
    write_pairs_fasta(str(path), pairs)
    return str(path)


@pytest.mark.parametrize("argv", [
    ["align", "-m", "global", "-W", "64"],
    ["align", "-W", "0", "-O", "4", "-E", "2", "-Q", "10", "-P", "1"],
    ["edit", "-m", "global", "-W", "64"],
    ["edit", "-m", "overlap"],
    ["edit", "-m", "kmer", "-k", "11"],
])
def test_debug_cli_matches_jax(fasta, argv, monkeypatch):
    monkeypatch.setattr(JCLI, "USE_DEVICE", False)
    monkeypatch.setattr(TCLI, "USE_DEVICE", False)
    want = _jax_cli(argv + [fasta])
    got = _stdout(TCLI.main, argv[:1] + ["--device", "cpu"] + argv[1:]
                  + [fasta])
    assert got == want and want.count("\n") == 12


def _rs(mod, q, t):
    rs = mod.AlnResult()
    rs.qe, rs.te = len(q) - 1, len(t) - 1
    return rs


# (query, target, cigar): the cases of tests/test_cigar_utils.py
CIGAR_CASES = [
    ("ACGTTTTA", "ACGTTTA", [(3 << 4) | 0, (1 << 4) | 1, (4 << 4) | 0]),
    ("ACGTTTTA", "ACGTTTA", [(6 << 4) | 0, (1 << 4) | 1, (1 << 4) | 0]),
    ("ACGTACGTAA", "ACGACGTGAA", [(3 << 4) | 0, (1 << 4) | 1, (4 << 4) | 0,
                                  (1 << 4) | 2, (2 << 4) | 0]),
]


@pytest.mark.parametrize("case", range(len(CIGAR_CASES)))
def test_cigar_helpers_match_jax(case):
    qs, ts, cigars = CIGAR_CASES[case]
    q, t = encode_dna(qs), encode_dna(ts)
    assert TC.cigars_to_str(cigars) == JC.cigars_to_str(cigars)
    got = TC.left_tidy_cigars(q, t, _rs(TC, q, t), list(cigars))
    want = JC.left_tidy_cigars(q, t, _rs(JC, q, t), list(cigars))
    assert got == want
    assert vars(TC.cigar_stats(q, t, 0, 0, cigars)) \
        == vars(JC.cigar_stats(q, t, 0, 0, cigars))


def _win(seed, n=6, L=150):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.uint8)
    reads = []
    for _ in range(n):
        r = rng.random(L)
        keep = r >= 0.04
        read = np.where(r < 0.08, rng.integers(0, 4, L), ref)[keep]
        reads.append(read.astype(np.uint8))
    return reads


def test_run_windows_forked_matches_jax():
    wins = [_win(s) for s in range(4)]
    par = default_poa_par()
    want = j_run_windows(wins, par, nproc=2)
    got = PB.run_windows(wins, par, nproc=2, device="cpu")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert np.array_equal(a.cns, b.cns)
        assert np.array_equal(a.qlt, b.qlt)
        assert np.array_equal(a.alt, b.alt)
        assert a.snvs == b.snvs and len(a.cns) > 100


def test_run_windows_refuses_workers_on_cuda():
    with pytest.raises(ValueError, match="fork"):
        PB.run_windows([_win(0), _win(1)], None, nproc=2, device="cuda")
