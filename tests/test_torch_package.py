"""Package boundaries of bsalign_tpu_torch: it runs without jax and without
bsalign_tpu, never drops from CUDA to the CPU, and its CPU path never
launches the CUDA kernels."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsalign_tpu_torch import cli
from bsalign_tpu_torch.ops import _cuda
from bsalign_tpu_torch.ops import banded8 as K

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from bsalign_tpu_torch import native
from bsalign_tpu_torch.align.editdist import edit_batch
from bsalign_tpu_torch.align.pairwise import align_batch
from bsalign_tpu_torch.constants import MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.ops import _cuda
from bsalign_tpu_torch.oracle import banded8 as O
rng = np.random.default_rng(5)
ts = [rng.integers(0, 4, 120).astype(np.uint8) for _ in range(3)]
qs = [t[5:].copy() for t in ts]
out = align_batch(qs, ts, MODE_OVERLAP, 32, O.set_score_matrix(2, -6),
                  -3, -2, 0, 0, device="cpu")
eout = edit_batch(qs, ts, MODE_GLOBAL, 0, device="cpu")
from bsalign_tpu_torch.ops import pedit
from bsalign_tpu_torch.poa import batch, cat, cli as pcli, core, extras, graph
from bsalign_tpu_torch.parallel import dist, loopback, mesh
from bsalign_tpu_torch.io import filereader, filewriter, pgzf
from bsalign_tpu_torch.utils import bitvec, objstore, sort, sysinfo, workers
win = ["".join("ACGT"[b] for b in ts[0][i:]) for i in (0, 2, 4, 6)]
pout = batch.run_windows([win], core.BSPOAPar(), device="cpu")
print(json.dumps({"mods": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "bsalign_tpu")),
                  "launches": _cuda.launches_codes + _cuda.launches_planes
                              + _cuda.launches_none,
                  "edit_launches": _cuda.edit_launches,
                  "pedit_launches": _cuda.pedit_launches,
                  "poa_cns": len(pout[0].cns),
                  "walker_source": native.SOURCE,
                  "walker_built": os.listdir(os.path.dirname(
                      native.rowops_lib()._name)),
                  "mat": [rs.mat for rs, _ in out],
                  "edit": [(rs.mat, rs.dele, rs.score) for rs, _ in eout]}))
"""


def test_cpu_path_imports_neither_jax_nor_bsalign_tpu(tmp_path):
    """align, edit and poa (every module of poa/ and ops/pedit.py) on the
    CPU from a copy of the port alone: no bsalign_tpu beside it, so the
    host library builds from the port's own rowops.cpp, and neither jax
    nor bsalign_tpu is imported."""
    pkg = tmp_path / "bsalign_tpu_torch"
    shutil.copytree(os.path.join(REPO, "bsalign_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["mods"] == []
    assert res["launches"] == res["edit_launches"] == 0
    assert res["pedit_launches"] == 0
    assert 110 <= res["poa_cns"] <= 120
    assert res["walker_source"] == str(pkg / "native" / "rowops.cpp")
    assert any(f.startswith("rowops-") for f in res["walker_built"])
    assert res["mat"] == [115, 115, 115]
    assert res["edit"] == [[115, 5, 5]] * 3


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(2)
    path = tmp_path / "p.fa"
    write_pairs_fasta(str(path), [gen_pair(rng, 60, 0.1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["align", str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["align", "--device", "cuda", str(path)])
    for argv in (["edit"], ["edit", "--device", "cuda"],
                 ["edit", "-m", "kmer", "--device", "cuda"], ["poa"],
                 ["poa", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + [str(path)])


def test_cpu_tensors_take_the_plain_version():
    """forward_raw takes the plain version because its tensors lie on the
    CPU; the kernel's launcher refuses CPU tensors before any build or
    launch."""
    rng = np.random.default_rng(3)
    q, t = gen_pair(rng, 50, 0.1)
    from bsalign_tpu_torch.align import pairwise as P
    from bsalign_tpu_torch.oracle import banded8 as O
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch([q], [t], 32)
    us, es, qs, ub, _ = P._init_state(1, 32, 1, 2, -6, -3, -2, 0, 0, 1)
    st = K.state_from_numpy(qpad, qlens, tpad, tlens,
                            P._mtx5(O.set_score_matrix(2, -6)), rby, us, es,
                            qs, ub, T=T, device="cpu")
    g = K.Geometry(T, 2, 1, 1, -3, -2, 0, 0, 2, -6, "codes")
    before = _cuda.launches_codes
    raw, plain = K.forward_raw(g, st), K.forward_plain(g, st)
    for fld in ("codes", "begs", "fin_ub", "fin_reg"):
        assert torch.equal(raw[fld], plain[fld]), fld
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.banded8_rows(g, st)
    assert _cuda.launches_codes == before


def test_two_piece_gaps_not_yet_ported():
    """2-piece gap costs (-Q/-P), which the port once refused, now align on
    the CPU path through the planes emit and backcal, launching no kernel."""
    from bsalign_tpu_torch.align import pairwise as P
    from bsalign_tpu_torch.oracle import banded8 as O
    rng = np.random.default_rng(4)
    q, t = gen_pair(rng, 80, 0.1)
    before = (_cuda.launches_codes, _cuda.launches_planes,
              _cuda.launches_none)
    [(rs, cg)] = P.align_batch([q], [t], 0, 64, O.set_score_matrix(2, -6),
                               -4, -2, -24, -1, device="cpu")
    assert (rs.qb, rs.qe, rs.tb, rs.te) == (0, len(q), 0, len(t))
    assert rs.mat + rs.mis + rs.ins + rs.dele == rs.aln > 0 and cg
    assert (_cuda.launches_codes, _cuda.launches_planes,
            _cuda.launches_none) == before
