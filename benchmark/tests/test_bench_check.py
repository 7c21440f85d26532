"""The output check fails what it must: each fault the align cells can
have, planted under the harness on the program's plain path, and the
control (the reference with its ties broken toward gaps) in the program's
place."""
import time

import pytest

import control
from harness import core

SEED = 2 ** 31 + 99


def _stale(drv):
    """Each call returns the call before's answers: state left unchanged."""
    real, last = drv.call, []

    def call(pairs):
        out = real(pairs)
        prev = last[:] or out
        last[:] = out
        return prev
    drv.call = call


def _half(drv):
    """Half of the batch left out, its answers filled from the rest."""
    real = drv.call

    def call(pairs):
        h = len(pairs) // 2
        out = real(pairs[:h])
        return out + out[:len(pairs) - h]
    drv.call = call


def _altered(drv):
    """Each answer altered where it is produced: the forward's score + 1."""
    real = drv.call

    def call(pairs):
        out = real(pairs)
        for rs, _ in out:
            rs.score += 1
        return out
    drv.call = call


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", ["default.tiny", "mapont.tiny"])
def test_bench_fault_is_not_correct(bench_copy, cell, fault):
    # a window of a few calls: a stale answer shows from the second on
    res = core.run(cell, SEED, 1.0, False, time.perf_counter(),
                   device="cpu", root=bench_copy, driver_hook=fault)
    assert res["correct"] is False
    assert res["checks"]["mismatched_pairs"]["value"] > 0


@pytest.mark.parametrize("cell, config", [
    ("default.tiny", "bsalign-default"), ("mapont.tiny", "mapont-w64")])
def test_bench_control_is_not_correct(bench_copy, cell, config):
    import os
    bench = os.path.join(bench_copy, "benchmark")
    cfg = core.load_json("configs", config, bench)
    ref = core.load_module("references", cfg["reference"], bench)
    res = core.run(cell, SEED, 0.5, False, time.perf_counter(),
                   device="cpu", root=bench_copy,
                   driver_hook=control.hook(ref, cfg["align"]))
    assert res["correct"] is False
    assert res["checks"]["mismatched_pairs"]["value"] > 0
