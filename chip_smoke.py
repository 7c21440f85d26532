#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsalign_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit, then the build of the
   banded-8 CUDA kernel (nvcc, sm_90a) and of the host codes walker (g++),
   with their build seconds.
2. Kernel against its plain PyTorch version, both on the card, on seeded
   pairs at 10% error: codes, begs, score/qe/te and the final state must
   agree bit for bit (tolerance 0: the arithmetic is integer).
3. The main path: `align_batch` on 512 pairs x 2 kb, global, band 128,
   -M 2 -X 6 -O 3 -E 2. The kernel's launch count over that run must be at
   least 2 (two DEVICE_CHUNKs), and the TSV of the first 32 pairs must equal
   the port's CPU path byte for byte. Prints kernel time, cells/s and
   end-to-end pairs/s.
4. Band 2048: 16 pairs x 2 kb at the CLI defaults (overlap, band
   roundup(qlen, 128)), checked against the CPU path on 2 pairs.

The line before the last is a JSON object with the kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository beside it, the script fails and prints no
result. It imports neither jax nor bsalign_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016


def fail(msg: str) -> int:
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    return 1


def gen_pairs(n, length, err=0.10, seed=0):
    """Seeded (query, target) pairs: the target is uniform random, the
    query carries substitutions, insertions and deletions at rate err."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, length).astype(np.uint8)
        q = []
        i = 0
        while i < length:
            r = rng.random()
            if r < err * 0.23:
                q.append((int(t[i]) + rng.integers(1, 4)) & 3)
                i += 1
            elif r < err * 0.54:
                q.append(rng.integers(0, 4))
            elif r < err:
                i += 1
            else:
                q.append(int(t[i]))
                i += 1
        qs.append(np.array(q, np.uint8))
        ts.append(t)
    return qs, ts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(HERE, "bsalign_tpu_torch")):
        return fail("bsalign_tpu_torch is not beside this script")
    sys.path.insert(0, HERE)
    from bsalign_tpu_torch import cli as CLI
    from bsalign_tpu_torch import native
    from bsalign_tpu_torch.align import pairwise as P
    from bsalign_tpu_torch.constants import (MODE_GLOBAL, MODE_OVERLAP,
                                             MODE_EXTEND, roundup)
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import banded8 as K
    from bsalign_tpu_torch.oracle import banded8 as O
    from bsalign_tpu_torch.utils import metrics

    dev = torch.device("cuda", 0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    # ---- phase 1: environment and builds ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"device: {name}")
    print(smi_line)   # the card's name and power limit, as nvidia-smi says
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _cuda.lib()
    native.rowops_lib()
    print(f"build: kernel {_cuda.build_seconds:.1f}s (nvcc sm_90a), "
          f"walker {native.build_seconds:.1f}s (g++)")

    mtx = O.set_score_matrix(2, -6)
    smax, smin = int(mtx.max()), int(mtx.min())

    def operands(qs, ts, mode, bw, gaps):
        pw = O.get_piecewise(*gaps, bw)
        qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bw)
        us, es, qs0, ub, _ = P._init_state(mode, bw, pw, smax, smin, *gaps,
                                           len(qs))
        g = K.Geometry(T, bw // 16, mode, pw, *gaps, smax, smin, True)
        st = K.state_from_numpy(qpad, qlens, tpad, tlens, P._mtx5(mtx), rby,
                                us, es, qs0, ub, T=T, device=dev)
        return g, st

    def timed_ms(fn, reps):
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

    def compare(g, st):
        """Kernel vs plain on the same device tensors; returns max |diff|
        over every output word (0 when bit-exact), the disagreements, and
        the plain version's milliseconds."""
        rk = _cuda.banded8_codes(g, st)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rp = K.forward_plain(g, st)
        e1.record()
        torch.cuda.synchronize()
        worst = 0
        pairs = [("codes", rk["codes"], rp["codes"]),
                 ("begs", rk["begs"], rp["begs"]),
                 ("fin_ub", rk["fin_ub"], rp["fin_ub"]),
                 ("fin_reg", rk["fin_reg"], rp["fin_reg"])]
        pairs += [(f"fin_plane{k}", a, b) for k, (a, b) in
                  enumerate(zip(rk["fin_planes"], rp["fin_planes"]))]
        fk = K.finish(g, rk, st.qlen, st.tlen)
        fp = K.finish(g, rp, st.qlen, st.tlen)
        pairs += [("score", fk.score, fp.score), ("qe", fk.qe, fp.qe),
                  ("te", fk.te, fp.te)]
        bad = []
        for nm, a, b in pairs:
            if a.shape != b.shape:
                bad.append(f"{nm} shape {tuple(a.shape)} vs {tuple(b.shape)}")
                continue
            d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            worst = max(worst, d)
            if d:
                bad.append(f"{nm} max|diff| {d}")
        return worst, bad, e0.elapsed_time(e1)

    # ---- phase 2: kernel against the plain version on the card ----
    cases = [
        ("64x2kb band128 global pw1", 64, 2000, 128, MODE_GLOBAL,
         (-3, -2, 0, 0), 1),
        ("64x2kb band128 overlap pw1", 64, 2000, 128, MODE_OVERLAP,
         (-3, -2, 0, 0), 2),
        ("64x2kb band128 extend pw0", 64, 2000, 128, MODE_EXTEND,
         (0, -4, 0, 0), 3),
        ("8x600bp band640 overlap pw1", 8, 600, 640, MODE_OVERLAP,
         (-3, -2, 0, 0), 4),
    ]
    max_err = 0
    for label, n, L, bw, mode, gaps, s in cases:
        qs, ts = gen_pairs(n, L, 0.10, SEED + s)
        g, st = operands(qs, ts, mode, bw, gaps)
        err, bad, p_ms = compare(g, st)
        max_err = max(max_err, err)
        k_ms = timed_ms(lambda: _cuda.banded8_codes(g, st), 5)
        print(f"phase2 {label}: W={g.W} T={g.T} max_abs_err={err}; "
              f"kernel {k_ms:.3f} ms, plain on the card {p_ms:.1f} ms")
        if bad:
            return fail(f"phase 2 {label}: kernel disagrees with plain: "
                        + "; ".join(bad))
    # global steering past the band (qlen >> tlen at band 16): full reset
    rng = np.random.default_rng(SEED + 6)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (800, 900, 700)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
    g, st = operands(qs, ts, MODE_GLOBAL, 16, (-3, -2, 0, 0))
    err, bad, _ = compare(g, st)
    max_err = max(max_err, err)
    print(f"phase2 3 pairs band16 global full band reset: max_abs_err={err}")
    if bad:
        return fail("phase 2 full reset: kernel disagrees with plain: "
                    + "; ".join(bad))

    # ---- phase 3: the main path ----
    gaps = (-3, -2, 0, 0)
    bw = 128
    qs, ts = gen_pairs(512, 2000, 0.10, SEED)
    g_main, st_main = operands(qs[:P.DEVICE_CHUNK], ts[:P.DEVICE_CHUNK],
                               MODE_GLOBAL, bw, gaps)
    err, bad, plain_ms = compare(g_main, st_main)
    max_err = max(max_err, err)
    if bad:
        return fail("phase 3 chunk: kernel disagrees with plain: "
                    + "; ".join(bad))
    kernel_ms = timed_ms(lambda: _cuda.banded8_codes(g_main, st_main), 5)
    cells = float(sum(len(t) for t in ts[:P.DEVICE_CHUNK])) * bw
    print(f"phase3 kernel: {kernel_ms:.3f} ms per launch of "
          f"{P.DEVICE_CHUNK} pairs (T={g_main.T}, W={g_main.W}), "
          f"{cells / (kernel_ms / 1e3):.4g} cells/s; plain on the card "
          f"{plain_ms:.1f} ms")

    torch.cuda.synchronize()
    metrics.reset()
    _cuda.launches = 0
    t0 = time.time()
    res_gpu = P.align_batch(qs, ts, MODE_GLOBAL, bw, mtx, *gaps, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches = _cuda.launches
    print(f"phase3 align_batch: 512 pairs in {e2e_s:.3f}s = "
          f"{512 / e2e_s:.2f} pairs/s, kernel launches {launches}")
    for nm, c in sorted(metrics.counters().items()):
        print(f"phase3 counter {nm}: {c.cells:.6g} units in {c.seconds:.4f}s "
              f"over {c.calls} calls")
    if launches < 2:
        return fail(f"main path launched the kernel {launches} times (< 2)")
    if len(res_gpu) != 512:
        return fail(f"align_batch returned {len(res_gpu)} results")
    for b, (rs, cg) in enumerate(res_gpu):
        if not (rs.mat > 0 and rs.aln > 0 and cg and rs.qe == len(qs[b])
                and rs.te == len(ts[b])):
            return fail(f"pair {b}: implausible global alignment {rs}")

    def tsv(results, idx, qs, ts):
        return "".join(CLI._fmt_pairwise(f"q{b}", f"t{b}", qs[b], ts[b],
                                         rs, cg)
                       for b, (rs, cg) in zip(idx, results))

    t0 = time.time()
    res_cpu = P.align_batch(qs[:32], ts[:32], MODE_GLOBAL, bw, mtx, *gaps,
                            device="cpu")
    cpu_s = time.time() - t0
    if tsv(res_gpu[:32], range(32), qs, ts) != tsv(res_cpu, range(32), qs,
                                                   ts):
        return fail("phase 3: TSV of the first 32 pairs differs from the "
                    "CPU path")
    print(f"phase3 TSV of 32 pairs == CPU path ({cpu_s:.1f}s on the CPU)")

    # ---- phase 4: band 2048 at the CLI defaults ----
    gaps = (-3, -2, 0, 0)
    qs, ts = gen_pairs(16, 2000, 0.10, SEED + 5)
    buckets = {}
    for i, q in enumerate(qs):
        buckets.setdefault(roundup(len(q), 128), []).append(i)
    torch.cuda.synchronize()
    t0 = time.time()
    res4 = [None] * len(qs)
    for b4, idxs in buckets.items():
        out = P.align_batch([qs[i] for i in idxs], [ts[i] for i in idxs],
                            MODE_OVERLAP, b4, mtx, *gaps, device=dev)
        for i, r in zip(idxs, out):
            res4[i] = r
    torch.cuda.synchronize()
    t4 = time.time() - t0
    print(f"phase4 band(s) {sorted(buckets)}: 16 pairs in {t4:.3f}s")
    check = [i for i in range(len(qs)) if roundup(len(qs[i]), 128) == 2048]
    if not check:
        return fail("phase 4: no pair lands in the band-2048 bucket")
    check = check[:2]
    cpu4 = P.align_batch([qs[i] for i in check], [ts[i] for i in check],
                         MODE_OVERLAP, 2048, mtx, *gaps, device="cpu")
    if tsv([res4[i] for i in check], check, qs, ts) != tsv(cpu4, check, qs,
                                                           ts):
        return fail("phase 4: band-2048 TSV differs from the CPU path")
    print(f"phase4 band 2048 pairs {check} == CPU path")

    for mod in ("jax", "bsalign_tpu"):
        if mod in sys.modules:
            return fail(f"{mod} was imported")
    print(json.dumps({"kernels": [{
        "name": "banded8_codes", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/banded8.cu",
        "replaces": "bsalign_tpu/ops/banded8_pallas.py:742",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
