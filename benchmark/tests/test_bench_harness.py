"""The harness on the CPU: cells found by name, a cell added by data alone,
and the output check on the program's plain path."""
import json
import os
import time

import pytest

from harness import core

SEED = 2 ** 31 + 12345      # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", ["default.tiny", "mapont.tiny"])
def test_bench_new_cell_runs_correct(bench_copy, cell):
    """A traffic file, a configuration and BENCHMARK.json entries, with no
    other file edited, give a cell that runs and checks correct."""
    res = core.run(cell, SEED, 0.2, False, time.perf_counter(),
                   device="cpu", root=bench_copy)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert {"bases_per_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert res["pairs_checked"] > 0


def test_bench_trace_run_reads_counters(bench_copy):
    res = core.run("mapont.tiny", SEED + 1, 0.2, True, time.perf_counter(),
                   device="cpu", root=bench_copy)
    assert res["correct"]
    assert res["metrics"]["walk.ms_per_call"]["value"] > 0
    assert res["metrics"]["driver.fetch_mb_per_call"]["value"] > 0
    # no device in a CPU run: the device's readers find nothing to read
    assert "banded8.roofline_pct" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_bench_everything_named_loads():
    """Every configuration, traffic, driver, reference and metric reader
    that BENCHMARK.json names is a file of its own, found by name."""
    spec = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
    for c in spec["configs"]:
        cfg = core.load_json("configs", c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"]
        core.load_module("drivers", cfg["driver"])
        assert callable(core.load_module("references",
                                         cfg["reference"]).answer)
    for w in spec["workloads"]:
        core.load_cell(spec, w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)
    with pytest.raises(core.NoResult):
        core.load_cell(spec, "no.such.cell")
