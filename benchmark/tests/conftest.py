"""Shared set-up of the benchmark's tests: the harness on the path, and a
copy of the benchmark with small cells that the program's plain (CPU) path
runs in seconds."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

TINY_TRAFFIC = {"name": "tiny", "pairs_per_call": 4,
                "target_len": 120, "error": 0.10}


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout's copy of BENCHMARK.json and benchmark/ with small cells
    added as a later change would add them: a traffic file, a
    configuration file and entries in BENCHMARK.json, nothing else
    edited. "default.tiny" runs bsalign-default; "mapont.tiny" runs
    minimap2-map-ont's costs at -W 64, so that the band moves."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "benchmark" / "workloads" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    cfg = json.loads((tmp_path / "benchmark" / "configs" /
                      "minimap2-map-ont.json").read_text())
    cfg["name"] = "mapont-w64"
    cfg["align"]["W"] = 64
    (tmp_path / "benchmark" / "configs" / "mapont-w64.json").write_text(
        json.dumps(cfg))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    spec["configs"].append({"name": "mapont-w64", "source": cfg["source"],
                            "file": "benchmark/configs/mapont-w64.json",
                            "reduced": ["align"], "why": "a test's config"})
    for name, config in (("default.tiny", "bsalign-default"),
                         ("mapont.tiny", "mapont-w64")):
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "a test's cell"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)
