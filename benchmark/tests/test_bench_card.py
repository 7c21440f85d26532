"""The cells on the card, briefly (marker `cuda`: skips without a card).

Run on a machine with the card: python -m pytest benchmark/tests -m cuda
"""
import json
import os
import time

import pytest

from harness import core


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["default.2kb.fullband",
                                  "mapont.2kb.band512"])
def test_bench_cell_on_the_card(card, cell, trace):
    res = core.run(cell, 2 ** 31 + 17, 2.0, trace, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    spec = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
    cell_spec, _, _ = core.load_cell(spec, cell)
    for m in core.metrics_of(spec, cell_spec, trace):
        assert res["metrics"][m["name"]]["value"] > 0, m["name"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        if "banded8.roofline_pct" in res["metrics"]:
            assert res["metrics"]["banded8.roofline_pct"]["value"] <= 100
