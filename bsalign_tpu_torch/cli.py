"""bsalign-tpu-torch command line: `align`, `edit`, `poa` and `cat` (port
of bsalign_tpu.cli).

Flags and output are those of `python -m bsalign_tpu.cli align`, `... edit`,
`... poa` and `... cat`, byte for byte, plus `--device {cuda,cpu}`: `cuda`
(the default) runs the DP in the hand-written CUDA kernels and raises when
no CUDA device is present; `cpu` runs their plain PyTorch versions. Input
pairs of `align` and `edit` are consecutive FASTA/Q records (q, t, q, t,
...); `poa` takes one window's reads; `cat` joins pieces in file order.

`align` and `edit` take `--dist` (or BSA_DIST=1): every process of a gloo
process group (parallel/dist.py) runs a contiguous shard of the pairs on
its own device, and process 0 prints the gathered output. BSA_PROFILE_DIR
writes a torch.profiler trace of the run (utils/metrics.profile_trace).

`align` runs every gap model on the device: 2-piece gap costs (-Q/-P)
through the banded-8 kernel's planes emit and the host's backcal, and
targets longer than 4,096 rows in resumable row chunks (past 16,384 rows,
a scores-only pass and then codes re-forwarded chunk by chunk). Any band
runs: past the kernel's shared memory its planes live in device memory,
and a batch whose per-row outputs pass the driver's LAUNCH_BYTES runs in
groups of pairs; past the card's memory, allocation fails.

USE_DEVICE = False (a debug constant) runs the scalar engines instead:
`align` the numpy oracle (oracle/banded8.pairwise), `edit` the host
C++ (oracle/edit.edit_pairwise / kmer_edit_pairwise), one pair at a time.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import torch

from . import cigar as C
from . import seqs as S
from .constants import MODE_NAMES, parse_mode_list, roundup
from .oracle import banded8 as B8
from .utils import metrics

USE_DEVICE = True  # flip off to run the scalar oracle engines (debug)


def _fmt_pairwise(qtag, ttag, qseq, tseq, rs, cigars, line=0):
    q, m, t = C.cigar2alnstr(qseq, tseq, rs, cigars, rs.aln)
    head = (f"{qtag}\t{len(qseq)}\t+\t{rs.qb}\t{rs.qe}\t{ttag}\t{len(tseq)}"
            f"\t+\t{rs.tb}\t{rs.te}\t{rs.score}\t{1.0 * rs.mat / rs.aln:.3f}"
            f"\t{rs.mat}\t{rs.mis}\t{rs.ins}\t{rs.dele}")
    if line <= 0:
        return f"{head}\n{q}\n{m}\n{t}\n"
    # -L > 0: wrap alnstr in 100-char chunks with running coordinates
    # (main.c:349-363; the chunk width is hardcoded 100 upstream)
    out = [head]
    qn, tn = rs.qb, rs.tb
    for b in range(0, rs.aln, 100):
        e = min(b + 100, rs.aln)
        qn += sum(1 for ch in q[b:e] if ch != "-")
        tn += sum(1 for ch in t[b:e] if ch != "-")
        out.append(f"{q[b:e]}\tQ[{qn}]")
        out.append(m[b:e])
        out.append(f"{t[b:e]}\tT[{tn}]")
    return "\n".join(out) + "\n"


def _read_pairs(paths: List[str]):
    recs = []
    for p in paths:
        recs.extend(S.read_fastx(p))
    recs = [r for r in recs if len(r.seq)]
    return [(recs[i], recs[i + 1]) for i in range(0, len(recs) - 1, 2)]


def resolve_device(name: str) -> torch.device:
    """The device for --device; `cuda` without a CUDA device raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain PyTorch path)")
    return torch.device(name)


def _shard(args, pairs):
    """(dist_on, n_total, this process's pairs, its device): with --dist
    or BSA_DIST, join the process group and keep this process's shard."""
    from .parallel import dist
    dist_on = args.dist or dist.enabled_by_env()
    n_total = len(pairs)
    if not dist_on:
        return False, n_total, pairs, resolve_device(args.device)
    dist.init()
    device = resolve_device(args.device)
    pairs = [pairs[i] for i in dist.process_shard(n_total)]
    return True, n_total, pairs, dist.process_device(device.type)


def _emit(dist_on: bool, n_total: int, texts: List[str]) -> None:
    """Write the TSV blocks; with --dist, process 0 writes every process's
    blocks in input order."""
    if not dist_on:
        sys.stdout.write("".join(texts))
        return
    from .parallel import dist
    full = dist.distribute_texts(n_total, texts)
    if full is not None:
        sys.stdout.write("".join(full))
    dist.shutdown()


def main_align(argv):
    ap = argparse.ArgumentParser(prog="bsalign-tpu-torch align")
    ap.add_argument("-m", default="overlap", help="global/extend/overlap")
    ap.add_argument("-W", type=int, default=0, help="bandwidth, 0=full")
    ap.add_argument("-M", type=int, default=2)
    ap.add_argument("-X", type=int, default=6)
    ap.add_argument("-O", type=int, default=3)
    ap.add_argument("-E", type=int, default=2)
    ap.add_argument("-Q", type=int, default=0)
    ap.add_argument("-P", type=int, default=0)
    ap.add_argument("-L", type=int, default=0)
    ap.add_argument("-R", type=int, default=1)
    ap.add_argument("-v", action="count", default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dist", action="store_true",
                    help="multi-process data parallel (torch.distributed)")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    metrics.set_verbose(args.v)
    mname = parse_mode_list(args.m)
    if mname is None:
        sys.stderr.write("bad -m mode list\n")
        return 1
    mode = MODE_NAMES[mname]
    mtx = B8.set_score_matrix(args.M, -args.X)
    gaps = (-args.O, -args.E, -args.Q, -args.P)
    pairs = _read_pairs(args.inputs)
    dist_on, n_total, pairs, device = _shard(args, pairs)

    if USE_DEVICE:
        from .align.pairwise import align_batch
        # bucket by effective bandwidth (full-band pairs share a bucket only
        # when their rounded qlen matches the reference's per-pair band)
        buckets = {}
        for idx, (q, t) in enumerate(pairs):
            bw = args.W if args.W > 0 else roundup(len(q.seq), 128)
            buckets.setdefault(bw, []).append(idx)
        results = [None] * len(pairs)
        for bw, idxs in buckets.items():
            qs = [pairs[i][0].codes for i in idxs]
            ts = [pairs[i][1].codes for i in idxs]
            outs = align_batch(qs, ts, mode, bw, mtx, *gaps, device=device)
            for i, r in zip(idxs, outs):
                results[i] = r
    else:
        results = []
        for (q, t) in pairs:
            bw = args.W if args.W > 0 else roundup(len(q.seq), 128)
            results.append(B8.pairwise(q.codes, t.codes, mode, bw, mtx,
                                       *gaps))

    _emit(dist_on, n_total,
          [_fmt_pairwise(q.tag, t.tag, q.codes, t.codes, rs, cg, args.L)
           if rs.mat else ""
           for (q, t), (rs, cg) in zip(pairs, results)])
    return 0


def main_edit(argv):
    ap = argparse.ArgumentParser(prog="bsalign-tpu-torch edit")
    ap.add_argument("-m", default="global", help="global/extend/overlap/kmer")
    ap.add_argument("-W", type=int, default=0)
    ap.add_argument("-k", type=int, default=13)
    ap.add_argument("-R", type=int, default=1)
    ap.add_argument("-v", action="count", default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dist", action="store_true",
                    help="multi-process data parallel (torch.distributed)")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    metrics.set_verbose(args.v)
    mode_name = parse_mode_list(args.m, ("global", "overlap", "extend",
                                         "kmer"))
    if mode_name is None:
        sys.stderr.write("bad -m mode list\n")
        return 1
    W = args.W
    if mode_name == "overlap" and W:
        sys.stderr.write(" ** disable band in bsalign-edit's overlap mode ** \n")
        W = 0
    pairs = _read_pairs(args.inputs)
    dist_on, n_total, pairs, device = _shard(args, pairs)

    if USE_DEVICE:
        from .align.editdist import edit_batch, kmer_edit_batch
        qs = [p[0].codes for p in pairs]
        ts = [p[1].codes for p in pairs]
        if mode_name == "kmer":
            results = kmer_edit_batch(args.k, qs, ts, device=device)
        else:
            results = edit_batch(qs, ts, MODE_NAMES[mode_name], W,
                                 device=device)
    else:
        from .oracle import edit as E
        results = []
        for (q, t) in pairs:
            if mode_name == "kmer":
                results.append(E.kmer_edit_pairwise(args.k, q.codes, t.codes))
            else:
                results.append(E.edit_pairwise(q.codes, t.codes,
                                               MODE_NAMES[mode_name], W))
    _emit(dist_on, n_total,
          [_fmt_pairwise(q.tag, t.tag, q.codes, t.codes, rs, cg)
           if rs.mat else ""
           for (q, t), (rs, cg) in zip(pairs, results)])
    return 0


def _device_arg(argv: List[str]) -> str:
    """The value of --device in argv (its default, cuda, when absent)."""
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write(
            "Usage: bsalign-tpu-torch <align|edit|poa|cat> [options] "
            "<fasta>\n")
        return 1
    cmd = argv[0].lower()
    # BSA_PROFILE_DIR=<dir> captures a torch.profiler trace of the whole run
    with metrics.profile_trace(_device_arg(argv[1:])):
        if cmd in ("align", "edit"):
            rc = (main_align if cmd == "align" else main_edit)(argv[1:])
            if metrics.verbose():
                metrics.report()
            return rc
        if cmd == "poa":
            from .poa.cli import run_poa
            return run_poa(argv[1:])
        if cmd == "cat":
            from .poa.cat import run_cat
            return run_cat(argv[1:])
    sys.stderr.write(f" -- Unknown command '{cmd}' --\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
