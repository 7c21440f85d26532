"""The output check's control at a cell's own size.

    python benchmark/control.py --workload <name> --seeds <n> [<n> ...] \
        [--seconds 10]

puts the plain reference, with its traceback's ties between a match and a
gap broken toward the gap, in the program's place, runs the cell's window
and check on each seed on the host (it needs no card), and prints one JSON
line a seed with the numbers compared. The check must call each of them
not correct. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import core  # noqa: E402


def hook(ref, params):
    """The driver hook that puts the reference `ref`, with its ties broken
    toward gaps, in the program's place: a call hands its pairs back and
    each kept answer is the control's."""
    def control(drv):
        drv.call = lambda pairs: pairs
        drv.answer = lambda out, j: ref.answer(params, *out[j], control=True)
    return control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        cell, cfg, _ = core.load_cell(json.load(f), args.workload)
    control = hook(core.load_module("references", cfg["reference"]),
                   cfg[cfg["driver"]])
    wrong = 0
    for seed in args.seeds:
        res = core.run(args.workload, seed, args.seconds, False,
                       time.perf_counter(), device="cpu",
                       driver_hook=control)
        wrong += not res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "pairs_checked": res["pairs_checked"],
                          "checks": res["checks"]}), flush=True)
    return 0 if wrong == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
