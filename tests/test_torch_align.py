"""`python -m bsalign_tpu_torch.cli align --device cpu` prints the same bytes
as `python -m bsalign_tpu.cli align` on the same FASTA.

Both CLIs run in this process, so the JAX engine's compiles are shared. On
the CPU the JAX package aligns through its XLA engine's planes and the
backcal traceback, while the port walks packed codes with the native
walker (piecewise 0/1) or the planes with backcal (2-piece gaps, -Q/-P):
byte-identical output also holds the codes walk to backcal.

The port's long-target routes (row chunks with codes, the two-pass mode,
row chunks with planes), forced by small T_CHUNK and REALIGN_T, give the
JAX package's align_batch results on the CPU.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from bsalign_tpu import cli as JCLI
from bsalign_tpu.align import pairwise as JP
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.constants import MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.oracle import banded8 as O

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

GAPS = {"affine": ["-O", "3", "-E", "2"], "linear": ["-O", "0", "-E", "4"],
        "two_piece": ["-O", "4", "-E", "2", "-Q", "24", "-P", "1"]}


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(11)
    pairs = [gen_pair(rng, L, 0.12) for L in (150, 190, 230, 250)]
    pairs.append(gen_pair(rng, 200, 0.25))
    path = tmp_path_factory.mktemp("torch_align") / "pairs.fa"
    write_pairs_fasta(str(path), pairs)
    return str(path)


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    assert rc == 0
    return buf.getvalue()


def _jax_cli(argv):
    old = sys.argv
    sys.argv = ["bsalign_tpu"] + argv
    try:
        return _stdout(JCLI.main)
    finally:
        sys.argv = old


def _torch_cli(argv):
    return _stdout(lambda: TCLI.main(argv + ["--device", "cpu"]))


@pytest.mark.parametrize("gaps", sorted(GAPS))
@pytest.mark.parametrize("band", ["0", "32", "128"])
@pytest.mark.parametrize("mode", ["global", "overlap", "extend"])
def test_align_stdout_matches_jax_cli(fasta, mode, band, gaps):
    argv = ["align", "-m", mode, "-W", band] + GAPS[gaps] + [fasta]
    want = _jax_cli(argv)
    assert want.count("\n") == 5 * 4
    assert _torch_cli(argv) == want


@pytest.mark.parametrize("band", ["256", "1024"])
@pytest.mark.parametrize("mode", ["global", "overlap", "extend"])
def test_align_wide_band_stdout_matches_jax_cli(fasta, mode, band):
    """-W 256 and -W 1024 (W 16 and 64 stripes: on the card the wide row
    from WIDE_W on), one gap model per mode."""
    gaps = {"global": "affine", "overlap": "two_piece",
            "extend": "linear"}[mode]
    argv = ["align", "-m", mode, "-W", band] + GAPS[gaps] + [fasta]
    want = _jax_cli(argv)
    assert want.count("\n") == 5 * 4
    assert _torch_cli(argv) == want


def test_align_wrapped_lines_match_jax_cli(fasta):
    argv = ["align", "-m", "global", "-W", "32", "-L", "100", fasta]
    assert _torch_cli(argv) == _jax_cli(argv)


def _long_batch(rng):
    """A deletion run across the row-chunk boundary at 384 (rows 370-409 of
    the target), a pair that ends before the later chunks, and a noisy
    full-length pair (T = 768 rows)."""
    t = rng.integers(0, 4, 640).astype(np.uint8)
    pairs = [(np.concatenate([t[:370], t[410:]]), t),
             gen_pair(rng, 300, 0.15), gen_pair(rng, 700, 0.18)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# (pairwise function that runs the route, mode, gap costs (gapo1, gape1,
# gapo2, gape2), REALIGN_T); T_CHUNK is 128 in each
ROUTES = [("_forward_chunked", MODE_GLOBAL, (-3, -2, 0, 0), 1024),  # codes
          ("_twopass_batch", MODE_OVERLAP, (-3, -2, 0, 0), 256),
          ("_forward_chunked", MODE_GLOBAL, (-4, -2, -24, -1), 256)]  # planes


@pytest.mark.parametrize("route", range(len(ROUTES)))
def test_long_target_routes_match_jax(monkeypatch, route):
    fn, mode, gaps, realign_t = ROUTES[route]
    monkeypatch.setattr(P, "T_CHUNK", 128)
    monkeypatch.setattr(P, "REALIGN_T", realign_t)
    calls = []
    real = getattr(P, fn)
    monkeypatch.setattr(P, fn,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    qs, ts = _long_batch(np.random.default_rng(19))
    mtx = O.set_score_matrix(2, -6)
    want = JP.align_batch(qs, ts, mode, 64, mtx, *gaps)
    got = P.align_batch(qs, ts, mode, 64, mtx, *gaps, device="cpu")
    assert calls == [1]
    for b, ((a1, c1), (a2, c2)) in enumerate(zip(got, want)):
        assert c1 == c2, b
        assert vars(a1) == vars(a2), b
