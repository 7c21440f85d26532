"""The trace reader on a hand-made Chrome trace (times in us)."""
import json

import pytest

from harness.devtrace import Trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_bench_devtrace_busy_idle_and_phases(tmp_path):
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.call", 100, 300),
          _x("user_annotation", "bench.call", 500, 400),
          _x("user_annotation", "bench.pack", 100, 55),
          _x("user_annotation", "bench.walk", 350, 50),
          _x("user_annotation", "bench.results", 360, 10),
          _x("user_annotation", "bench.pack", 500, 55),
          _x("user_annotation", "bench.walk", 760, 140),
          _x("cuda_runtime", "cudaLaunchKernel", 150, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 550, 5),
          _x("kernel", "void banded8_wide_kernel<1, 1, 0, false>(Params)",
             160, 140),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 300, 50),
          _x("kernel", "void banded8_wide_kernel<1, 1, 0, false>(Params)",
             560, 140),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 700, 60),
          _x("kernel", "outside_the_window", 2000, 10)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace(str(path))
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(390e-6)
    assert tr.op_seconds(lambda n: "banded8" in n) == pytest.approx(280e-6)
    assert tr.op_seconds(lambda n: "DtoH" in n) == pytest.approx(110e-6)
    idle = dict(tr.idle_by_phase())
    # the innermost span names each instant: "call" in a call outside
    # any phase, "harness" outside calls
    assert idle["harness"] == pytest.approx(300e-6)
    assert idle["walk"] == pytest.approx(180e-6)
    assert idle["results"] == pytest.approx(10e-6)
    assert idle["pack"] == pytest.approx(110e-6)
    assert idle["call"] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - tr.busy_s)
    top = tr.top_ops()
    assert top[0][0].startswith("void banded8") and len(top) == 2
