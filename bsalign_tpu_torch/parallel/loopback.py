"""Multi-process loopback of `align --dist` / `edit --dist` on one host
(the port's counterpart of tools/dist_loopback.py).

Starts N processes running `python -m bsalign_tpu_torch <cmd> --dist
--device <dev>` over one pair file, with a tcp:// rendezvous on a free
localhost port; process 0 prints the gathered output. Beside it, one
process runs the same command without --dist. On CUDA each process takes
card (process index % card count), so on one card all of them share it.

    python -m bsalign_tpu_torch.parallel.loopback pairs.fa \\
        [--cmd align] [--nprocs 2] [--device cuda|cpu] [-- -m global -W 128]

The device is the card unless --device cpu asks for the CPU.

Exit code 0 iff the gathered output equals the single process's, byte for
byte.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = PKG_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # gloo's transport listens on the loopback interface
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for k in ("BSA_COORD", "BSA_NPROCS", "BSA_PROC_ID", "BSA_DIST",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    if extra:
        env.update(extra)
    return env


def _cmd(cmd: str, device: str, flags: Sequence[str], path: str,
         dist: bool) -> List[str]:
    return ([sys.executable, "-m", "bsalign_tpu_torch", cmd, *flags,
             "--device", device] + (["--dist"] if dist else []) + [path])


def run_loopback(pair_file: str, *, cmd: str = "align", nprocs: int = 2,
                 device: str = "cuda", flags: Sequence[str] = (),
                 timeout: float = 600, env: Optional[Dict[str, str]] = None):
    """Run `cmd` once in one process and once in `nprocs` processes with
    --dist. Returns (single_stdout, gathered_stdout, info): info holds
    `single_s` and `dist_s` (each process's wall seconds, process start
    to exit) and `stderr` (each --dist process's). A process that fails or
    outlives `timeout` raises, and every process started is ended first."""
    t0 = time.time()
    single = subprocess.run(_cmd(cmd, device, flags, pair_file, False),
                            env=_env(env), capture_output=True, text=True,
                            timeout=timeout, cwd=PKG_ROOT)
    single_s = time.time() - t0
    if single.returncode != 0:
        raise RuntimeError(f"single-process {cmd} rc={single.returncode}:\n"
                           f"{single.stderr[-2000:]}")
    port = free_port()
    procs, starts = [], []
    try:
        for pid in range(nprocs):
            extra = dict(env or {})
            extra.update(BSA_COORD=f"tcp://127.0.0.1:{port}",
                         BSA_NPROCS=str(nprocs), BSA_PROC_ID=str(pid))
            starts.append(time.time())
            procs.append(subprocess.Popen(
                _cmd(cmd, device, flags, pair_file, True), env=_env(extra),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=PKG_ROOT))
        outs, errs, walls = [], [], []
        deadline = time.time() + timeout
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"--dist process {pid} outlived its "
                                   f"{timeout:.0f} s timeout")
            walls.append(time.time() - starts[pid])
            if p.returncode != 0:
                raise RuntimeError(f"--dist process {pid} rc={p.returncode}:"
                                   f"\n{err[-2000:]}")
            outs.append(out)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(outs[1:]):
        raise RuntimeError("a --dist process other than 0 printed output")
    return single.stdout, outs[0], dict(single_s=single_s, dist_s=walls,
                                        stderr=errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bsalign_tpu_torch.parallel.loopback")
    ap.add_argument("pairs")
    ap.add_argument("--cmd", default="align", choices=("align", "edit"))
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("flags", nargs="*", help="the command's own flags")
    args = ap.parse_args(argv)
    single, got, info = run_loopback(
        args.pairs, cmd=args.cmd, nprocs=args.nprocs, device=args.device,
        flags=args.flags, timeout=args.timeout)
    walls = ", ".join(f"{t:.2f}" for t in info["dist_s"])
    print(f"{args.cmd} --dist over {args.nprocs} processes: "
          f"{'same bytes' if got == single else 'DIFFERENT bytes'} "
          f"({len(got)} bytes); process walls {walls} s, single process "
          f"{info['single_s']:.2f} s")
    return 0 if got == single else 1


if __name__ == "__main__":
    sys.exit(main())
