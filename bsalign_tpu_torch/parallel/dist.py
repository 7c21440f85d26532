"""Multi-process data parallelism: process init, input sharding, host gather
(port of bsalign_tpu.parallel.dist on torch.distributed).

Alignment is embarrassingly parallel across pairs / POA windows
(SURVEY.md §2.6), so the multi-process story is purely data-parallel:

  1. every process calls :func:`init` (a gloo process group);
  2. the input work list is split per process (:func:`process_shard`);
  3. each process runs the normal single-process batched engines on its
     shard, on its own device (:func:`process_device`);
  4. variable-length results (TSV blocks) are gathered to every process as
     byte blobs (:func:`gather_blobs`) and the original order is restored;
     process 0 emits output.

What is gathered is host text, so the group uses the gloo backend on the
card as on the CPU (NCCL would need one card per process). Enable on the
CLI with --dist (or BSA_DIST=1). The rendezvous comes from BSA_COORD
(host:port or tcp://host:port) / BSA_NPROCS / BSA_PROC_ID; without them,
from torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
"""
from __future__ import annotations

import datetime
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..utils import metrics

# how long init and each collective wait for the other processes
TIMEOUT_S = 600


def enabled_by_env() -> bool:
    return bool(os.environ.get("BSA_DIST"))


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Join the gloo process group once per process (no-op on re-entry).

    BSA_COORD/BSA_NPROCS/BSA_PROC_ID (or the arguments) give a tcp://
    rendezvous; with none of them, torchrun's env:// variables do."""
    if tdist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("BSA_COORD")
    if num_processes is None and os.environ.get("BSA_NPROCS"):
        num_processes = int(os.environ["BSA_NPROCS"])
    if process_id is None and os.environ.get("BSA_PROC_ID"):
        process_id = int(os.environ["BSA_PROC_ID"])
    kwargs = {"backend": "gloo",
              "timeout": datetime.timedelta(seconds=TIMEOUT_S)}
    if coordinator:
        if "://" not in coordinator:
            coordinator = "tcp://" + coordinator
        kwargs["init_method"] = coordinator
        kwargs["world_size"] = 1 if num_processes is None else num_processes
        kwargs["rank"] = 0 if process_id is None else process_id
    else:
        kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    tdist.init_process_group(**kwargs)


def shutdown() -> None:
    """Leave the process group (no-op when there is none)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_info():
    """(process_index, process_count): (0, 1) without a process group."""
    if not tdist.is_initialized():
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()


def process_device(name: str) -> torch.device:
    """This process's device for --device `name`: on CUDA, card
    (LOCAL_RANK, else the process index) modulo the card count, so that
    processes on one card share it."""
    if name != "cuda":
        return torch.device(name)
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local else process_info()[0]
    return torch.device("cuda", idx % max(1, torch.cuda.device_count()))


def process_shard(n_items: int) -> range:
    """Contiguous slice of [0, n_items) owned by this process."""
    pid, pcnt = process_info()
    per = -(-n_items // pcnt)
    lo = min(pid * per, n_items)
    hi = min(lo + per, n_items)
    return range(lo, hi)


def _allgather(x: np.ndarray) -> np.ndarray:
    """[P, *x.shape]: every process's x (same shape and dtype everywhere),
    as CPU tensors over gloo."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, t)
    return torch.stack(out).numpy()


def gather_blobs(local_blobs: Sequence[bytes]) -> List[List[bytes]]:
    """All-gather variable-length byte blobs across processes.

    Returns blobs[pid][i] for every process, so callers can reassemble
    results in input order. Without a process group, or with one process:
    [list(local_blobs)]. Two phases: the header (blob count and payload
    bytes of every process), then the blob lengths and the payload, each
    padded to the largest process's. The time goes to the `dist_gather`
    counter (bytes gathered)."""
    pid, pcnt = process_info()
    if pcnt == 1:
        return [list(local_blobs)]
    t0 = time.time()
    cat = b"".join(local_blobs)
    lens = np.array([len(b) for b in local_blobs], np.int64)
    hdrs = _allgather(np.array([len(lens), len(cat)], np.int64))  # [P, 2]
    max_n = int(hdrs[:, 0].max())
    max_b = int(hdrs[:, 1].max())
    lens_pad = np.zeros(max_n, np.int64)
    lens_pad[:len(lens)] = lens
    all_lens = _allgather(lens_pad)                               # [P, max_n]
    pay = np.zeros(max_b, np.uint8)
    pay[:len(cat)] = np.frombuffer(cat, np.uint8)
    all_pay = _allgather(pay)                                     # [P, max_b]
    out: List[List[bytes]] = []
    for p in range(pcnt):
        n = int(hdrs[p, 0])
        blobs, off = [], 0
        for i in range(n):
            ln = int(all_lens[p, i])
            blobs.append(all_pay[p, off:off + ln].tobytes())
            off += ln
        out.append(blobs)
    metrics.add("dist_gather", float(hdrs[:, 1].sum()), time.time() - t0)
    return out


def distribute_texts(items_total: int,
                     local_texts: Sequence[str]) -> Optional[List[str]]:
    """Gather per-item text results; returns the full ordered list on
    process 0 and None elsewhere."""
    blobs = gather_blobs([t.encode() for t in local_texts])
    if process_info()[0] != 0:
        return None
    full: List[Optional[str]] = [None] * items_total
    pcnt = len(blobs)
    for p in range(pcnt):
        per = -(-items_total // pcnt)
        lo = min(p * per, items_total)
        for k, blob in enumerate(blobs[p]):
            full[lo + k] = blob.decode()
    return [t if t is not None else "" for t in full]
