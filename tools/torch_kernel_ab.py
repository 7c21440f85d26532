#!/usr/bin/env python3
"""Time the port's edit and pedit kernels at their main-path shapes in one
or more trees of the port, in the order given, on one GPU.

    python3 tools/torch_kernel_ab.py TREE [TREE ...]

Each TREE is a directory holding a `bsalign_tpu_torch/` package (the
repository's root, or a `git archive` of another commit unpacked in a
git-ignored directory); each runs in its own process, so the same tree
may be named several times to alternate two versions (A, B, B, A). The
inputs are those of `chip_smoke.py`: 256 pairs x 2 kb at full band (NW 64)
for `edit_rows`, the first realignment round of 128 seeded POA windows
(2,560 jobs at band 32) for `pedit_rows`. They are made once with this
repository's package and kept in its git-ignored build directory. Per
tree it prints one JSON line: each kernel's milliseconds per launch over
20 launches of its launcher (CUDA events, after one warm-up launch) and a
hash of its outputs (rows below each pair's tlen for edit, the whole
matrices for pedit), so that versions which must agree byte for byte can
be seen to.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "bsalign_tpu_torch", "build", "kernel_ab_data.pkl")


def make_data():
    """Pickle the edit operands (numpy) and the pedit jobs' fields."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.constants import roundup
    from bsalign_tpu_torch.poa.core import BSPOA, BSPOAPar
    qs, ts = CS.gen_pairs(512, 2000, 0.10, CS.SEED + 20)
    idx = [i for i, q in enumerate(qs)
           if roundup(roundup(len(q), 64), 256) == 2048][:D.DEVICE_CHUNK]
    T, _, ops = D._pack_bucket([qs[i] for i in idx], [ts[i] for i in idx],
                               2048, False)
    rng = CS.np.random.default_rng(CS.SEED + 30)
    jobs = []
    for _ in range(128):
        g = BSPOA(BSPOAPar(), device="cpu")
        g.beg()
        for s in CS.gen_poa_window(rng):
            g.push(s)
        g.end_begin()
        g.msa()
        g.cns_call()
        ctx = g._remsa_prepare(g.par.editbw // 2, 1)
        jobs += g._remsa_dev_build(ctx, 0)[0]
    fields = [(j.seqs0, j.seqs1, j.mats0, j.mats1, j.mlen, j.mbeg, j.mend,
               j.bw, j.HW) for j in jobs]
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    with open(DATA, "wb") as f:
        pickle.dump((T, ops, fields), f)


def time_tree(tree):
    """One tree's times and output hashes, as a dict."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import edit as KE
    from bsalign_tpu_torch.ops import pedit as PE
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    with open(DATA, "rb") as f:
        T, ops, fields = pickle.load(f)
    g = KE.Geometry(T, 64, 0)
    eops = KE.operands_from_numpy(*ops, T=T, device=dev)
    pk = PE.pack_jobs([PE.PeditJob(*x) for x in fields], dev)

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    out = {"tree": tree,
           "edit_ms": timed(lambda: _cuda.edit_rows(g, eops)),
           "pedit_ms": timed(lambda: _cuda.pedit_rows(pk))}
    r = _cuda.edit_rows(g, eops)
    h = hashlib.sha1()
    for b, n in enumerate(eops.tlen.tolist()):
        for k in ("pm", "pp", "sbeg"):
            h.update(r[k][b, :n].cpu().numpy().tobytes())
    for k in ("fin_pm", "fin_pp", "scal"):
        h.update(r[k].cpu().numpy().tobytes())
    out["edit_hash"] = h.hexdigest()[:12]
    m0, m1 = _cuda.pedit_rows(pk)
    out["pedit_hash"] = hashlib.sha1(m0.cpu().numpy().tobytes()
                                     + m1.cpu().numpy().tobytes()
                                     ).hexdigest()[:12]
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(time_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    if not os.path.exists(DATA):
        make_data()
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
