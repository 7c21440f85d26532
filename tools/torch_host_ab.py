#!/usr/bin/env python3
"""Time the port's two host-bound main paths on one GPU with and without
`chip_smoke.py`'s phase-12 CPU reference running beside them.

    python3 tools/torch_host_ab.py

The paths and inputs are `chip_smoke.py`'s: `edit_batch` on 512 seeded
pairs x 2 kb, global, -W 0 (phase 6), and `run_windows_lockstep` on 32 of
phase 7's seeded POA windows (20 reads x 800 bp). Beside them runs `cat
--device cpu` on phase 12's first 8 windows, in a process of one thread,
once at the lowest priority (as `chip_smoke.py` starts it) and once not.
Each condition runs both paths twice, the order alone, niced, alone, not
niced, alone; each line prints the host-clock seconds and the rates.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as CS
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.constants import MODE_GLOBAL
    from bsalign_tpu_torch.poa import batch as PB
    from bsalign_tpu_torch.poa.core import BSPOAPar

    if not torch.cuda.is_available():
        sys.stderr.write("torch_host_ab: no CUDA device\n")
        return 1
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    qs, ts = CS.gen_pairs(512, 2000, 0.10, CS.SEED + 20)
    rng = np.random.default_rng(CS.SEED + 30)
    wins = [CS.gen_poa_window(rng) for _ in range(32)]
    D.edit_batch(qs[:8], ts[:8], MODE_GLOBAL, 0, device=dev)     # warm-up
    PB.run_windows_lockstep(wins[:2], BSPOAPar(), device=dev)
    tmp = tempfile.mkdtemp(prefix="bsa_host_ab_")
    first = os.path.join(tmp, "first.fa")
    with open(first, "w") as f:
        f.write(CS.gen_cat_windows(CS.SEED + 120)[1])

    def beside(nice):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        return subprocess.Popen(
            [sys.executable, "-m", "bsalign_tpu_torch", "cat", "--device",
             "cpu", first], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            preexec_fn=(lambda: os.nice(19)) if nice else None)

    def measure(label):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            D.edit_batch(qs, ts, MODE_GLOBAL, 0, device=dev)
            torch.cuda.synchronize()
            te = time.time() - t0
            t0 = time.time()
            PB.run_windows_lockstep(wins, BSPOAPar(), device=dev)
            torch.cuda.synchronize()
            tp = time.time() - t0
            print(f"{label}: edit_batch 512 x 2 kb {te:.3f}s = "
                  f"{512 / te:.2f} pairs/s; run_windows_lockstep 32 windows "
                  f"{tp:.3f}s = {32 / tp:.3f} windows/s", flush=True)

    measure("alone")
    for nice, label in ((True, "beside the niced CPU cat"),
                        (False, "beside the CPU cat, not niced")):
        p = beside(nice)
        try:
            measure(label)
        finally:
            p.kill()
            p.wait()
        measure("alone")
    return 0


if __name__ == "__main__":
    sys.exit(main())
