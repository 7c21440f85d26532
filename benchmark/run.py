"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`, the numbers the output check
compared, each with its limit; the same numbers close standard error.
Exits non-zero with no result when no CUDA device (or fewer than the cell
asks for) is present, when the program cannot be imported, or when JAX
or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = core.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START)
    except core.NoResult as e:
        sys.stderr.write(f"benchmark: no result: {e}\n")
        return 3
    q = res.pop("call_ms_quartiles")
    sys.stderr.write(f"calls {res['calls']}: ms min {q[0]:.2f}, quartiles "
                     f"{q[1]:.2f} {q[2]:.2f} {q[3]:.2f}, max {q[4]:.2f}\n")
    for name, c in sorted(res.pop("counters").items()):
        sys.stderr.write(f"counter {name}: {c['cells']:.6g} in "
                         f"{c['seconds']:.4f} s, {c['calls']} calls\n")
    sys.stderr.write(f"pairs checked against the reference: "
                     f"{res['pairs_checked']}\n")
    for name, c in res["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']} (limit "
                         f"{c['limit']})\n")
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
