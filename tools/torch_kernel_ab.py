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
(2,560 jobs at band 32) for `pedit_rows`; and the wide shapes of its phase
16: `edit -W 0`'s launch on 24.7 kb reads (14 pairs x 24,704 rows at NW
752) and 6 random jobs at bw 4,094 (`poa -G editbw=4096`'s band). They are
made once with this
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

import numpy as np

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
    # the wide shapes
    n, tl, ql = CS.WIDE_EDIT
    qs, ts = CS.wide_pairs(n, tl, ql, CS.SEED + 165)
    per = D._launch_pairs(roundup(tl, 128), 752)
    wT, _, wops = D._pack_bucket(qs[:per], ts[:per], 32 * 752, False)
    wide_fields = [wide_job(rng, int(rng.integers(200, 600)), 4094)
                   for _ in range(6)]
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    with open(DATA, "wb") as f:
        pickle.dump((T, ops, fields, wT, wops, wide_fields), f)


def wide_job(rng, mlen, bw):
    """A random pedit job's fields at band bw (chip_smoke.py's rand_job)."""
    HW = bw // 2
    pad = mlen + bw
    seqs0 = np.full(pad, 4, np.uint8)
    pos = np.sort(rng.choice(mlen, int(rng.integers(mlen // 2, mlen)),
                             replace=False))
    seqs0[HW + pos] = rng.integers(0, 4, len(pos))
    seqs1 = np.zeros(pad, np.uint8)
    seqs1[HW:HW + mlen] = rng.integers(0, 5, mlen)
    mats0 = np.zeros((4, pad), np.uint8)
    mats1 = np.zeros((4, pad), np.uint8)
    mats0[:, HW:HW + mlen] = rng.integers(0, 6, (4, mlen))
    mats1[:, HW:HW + mlen] = rng.integers(0, 251, (4, mlen))
    mbeg = int(rng.integers(0, mlen // 4))
    mend = int(rng.integers(mbeg + 2, mlen + 1))
    return (seqs0, seqs1, mats0, mats1, mlen, mbeg, mend, bw, HW)


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
        T, ops, fields, wT, wops, wide_fields = pickle.load(f)
    g = KE.Geometry(T, 64, 0)
    eops = KE.operands_from_numpy(*ops, T=T, device=dev)
    pk = PE.pack_jobs([PE.PeditJob(*x) for x in fields], dev)
    wg = KE.Geometry(wT, 752, 0)
    weops = KE.operands_from_numpy(*wops, T=wT, device=dev)
    wpk = PE.pack_jobs([PE.PeditJob(*x) for x in wide_fields], dev)

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

    def edit_hash(g, eops):
        r = _cuda.edit_rows(g, eops)
        h = hashlib.sha1()
        for b, n in enumerate(eops.tlen.tolist()):
            for k in ("pm", "pp", "sbeg"):
                h.update(r[k][b, :n].cpu().numpy().tobytes())
        for k in ("fin_pm", "fin_pp", "scal"):
            h.update(r[k].cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    def pedit_hash(pk):
        m0, m1 = _cuda.pedit_rows(pk)
        return hashlib.sha1(m0.cpu().numpy().tobytes()
                            + m1.cpu().numpy().tobytes()).hexdigest()[:12]

    out = {"tree": tree,
           "edit_ms": timed(lambda: _cuda.edit_rows(g, eops)),
           "pedit_ms": timed(lambda: _cuda.pedit_rows(pk)),
           "edit_wide_ms": timed(lambda: _cuda.edit_rows(wg, weops), 3),
           "pedit_wide_ms": timed(lambda: _cuda.pedit_rows(wpk), 5),
           "edit_hash": edit_hash(g, eops), "pedit_hash": pedit_hash(pk),
           "edit_wide_hash": edit_hash(wg, weops),
           "pedit_wide_hash": pedit_hash(wpk)}
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
