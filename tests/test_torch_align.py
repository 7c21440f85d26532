"""`python -m bsalign_tpu_torch.cli align --device cpu` prints the same bytes
as `python -m bsalign_tpu.cli align` on the same FASTA.

Both CLIs run in this process, so the JAX engine's compiles are shared. On
the CPU the JAX package aligns through its XLA engine's planes and the
backcal traceback, while the port walks packed codes with the native
walker: byte-identical output also holds the codes walk to backcal.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from bsalign_tpu import cli as JCLI
from bsalign_tpu_torch import cli as TCLI

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

GAPS = {"affine": ["-O", "3", "-E", "2"], "linear": ["-O", "0", "-E", "4"]}


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


def test_align_wrapped_lines_match_jax_cli(fasta):
    argv = ["align", "-m", "global", "-W", "32", "-L", "100", fasta]
    assert _torch_cli(argv) == _jax_cli(argv)
