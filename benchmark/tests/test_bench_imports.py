"""What the benchmark loads, seen from fresh processes."""
import json
import os
import subprocess
import sys

from harness import core

FORBIDDEN = ("jax", "bsalign_tpu")

PROBE = r"""
import json, sys, importlib.util
sys.path[:0] = [{bench!r}, {root!r}]
spec = importlib.util.spec_from_file_location("bench_entry", {entry!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
from harness import core
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(extra: str = "") -> set:
    code = PROBE.format(bench=core.BENCH, root=core.ROOT,
                        entry=os.path.join(core.BENCH, "run.py"), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_bench_entry_and_reference_load_no_jax():
    """The entry and the reference import neither JAX nor the JAX package
    (top-level names compared whole), and the reference nothing of the
    program."""
    mods = _top_modules(
        'ref = core.load_module("references", "banded_align")\n'
        'ref.align([0, 1, 2, 3], [0, 1, 2, 3], "global", 0, 2, -6, -3, -2)')
    assert not mods & set(FORBIDDEN + ("jaxlib", "flax"))
    assert "bsalign_tpu_torch" not in mods


def test_bench_driver_loads_no_jax():
    """The program under test, driven on its plain path, loads no JAX."""
    mods = _top_modules(
        'cfg = core.load_json("configs", "bsalign-default")\n'
        'drv = core.load_module("drivers", "align").Driver(cfg, "cpu")\n'
        'import numpy as np\n'
        'drv.call([(np.arange(32, dtype=np.uint8) % 4,) * 2])')
    assert "bsalign_tpu_torch" in mods
    assert not mods & set(FORBIDDEN + ("jaxlib", "flax"))


def test_bench_run_without_a_card_gives_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "default.2kb.fullband", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=core.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
