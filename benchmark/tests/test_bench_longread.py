"""The long-read cell's files on the CPU: `default.33kb.fullband`'s
configuration and reference, with its traffic shortened, run through the
harness on the program's plain path and its two-pass mode, read correct;
each fault that test_bench_check.py plants, and the control, read not
correct."""
import json
import os
import time

import pytest

import control
from harness import core
from test_bench_check import _altered, _half, _stale

SEED = 2 ** 31 + 4321
CELL = "default.33kb.fullband"


@pytest.fixture
def long_copy(bench_copy, monkeypatch):
    """The cell in a checkout's copy, its traffic cut to 4 pairs of 200 bp
    targets and its band to 256, which still covers every query: the
    plain forward loops over the band's stripes, so -W 32768 takes
    seconds a row on the CPU. Row chunks and a two-pass limit of 128 rows
    send the 256-row targets through the two-pass mode in 2 chunks."""
    from bsalign_tpu_torch.align import pairwise
    bench = os.path.join(bench_copy, "benchmark")
    traffic = core.load_json("workloads", "reads.33kb", bench)
    traffic.update(pairs_per_call=4, target_len=200)
    with open(os.path.join(bench, "workloads", "reads.33kb.json"), "w") as f:
        json.dump(traffic, f)
    cfg = core.load_json("configs", "bsalign-longread-fullband", bench)
    cfg["align"]["W"] = 256
    with open(os.path.join(bench, "configs",
                           "bsalign-longread-fullband.json"), "w") as f:
        json.dump(cfg, f)
    monkeypatch.setattr(pairwise, "T_CHUNK", 128)
    monkeypatch.setattr(pairwise, "REALIGN_T", 128)
    calls = []
    real = pairwise._twopass_batch
    monkeypatch.setattr(pairwise, "_twopass_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return bench_copy, calls


def test_bench_longread_cell_runs_correct(long_copy):
    root, calls = long_copy
    res = core.run(CELL, SEED, 0.5, True, time.perf_counter(), device="cpu",
                   root=root)
    assert res["correct"], res["checks"]
    assert calls, "the two-pass mode did not run"
    assert res["failed"] == 0 and res["pairs_checked"] > 0
    m = res["metrics"]
    assert m["twopass.pairs_per_launch"]["value"] == 4
    for name in ("twopass.score_ms_per_call",
                 "twopass.refwd_wait_ms_per_call", "walk.ms_per_call",
                 "driver.fetch_mb_per_call"):
        assert m[name]["value"] > 0, name


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_bench_longread_fault_is_not_correct(long_copy, fault):
    # a window of two calls at least: a stale answer shows from the second
    res = core.run(CELL, SEED, 3.0, False, time.perf_counter(), device="cpu",
                   root=long_copy[0], driver_hook=fault)
    assert res["correct"] is False
    assert res["checks"]["mismatched_pairs"]["value"] > 0


def test_bench_longread_control_is_not_correct(long_copy):
    bench = os.path.join(long_copy[0], "benchmark")
    cfg = core.load_json("configs", "bsalign-longread-fullband", bench)
    ref = core.load_module("references", cfg["reference"], bench)
    res = core.run(CELL, SEED, 0.5, False, time.perf_counter(),
                   device="cpu", root=long_copy[0],
                   driver_hook=control.hook(ref, cfg["align"]))
    assert res["correct"] is False
    assert res["checks"]["mismatched_pairs"]["value"] > 0


def test_bench_long_reference_loads_no_program():
    """The long reference imports neither JAX, the JAX package nor the
    program under test (top-level names compared whole)."""
    from test_bench_imports import FORBIDDEN, _top_modules
    mods = _top_modules(
        'ref = core.load_module("references", "banded_align_long")\n'
        'ref.align([0, 1, 2, 3], [0, 1, 2, 3], "global", 0, 2, -6, -3, -2,'
        ' device="cpu")')
    assert not mods & set(FORBIDDEN + ("jaxlib", "flax"))
    assert "bsalign_tpu_torch" not in mods
