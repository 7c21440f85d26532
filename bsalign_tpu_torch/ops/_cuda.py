"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, in the package's git-ignored build directory, on first use and
keyed by a hash of the sources; the library is loaded with ctypes.
Kernels launch on PyTorch's current stream and never synchronise; each C
entry point returns cudaGetLastError(), and a non-zero code raises.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch

from ..constants import MODE_GLOBAL, MODE_OVERLAP, WORDSIZE, mode_type
from ..utils.build import build_shared
from .banded8 import query_bytes

WS = WORDSIZE
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
PAIRS_PER_BLOCK = 2   # one warp per block: 256 pairs spread over 128 SMs
SMEM_MAX = 227 * 1024   # shared memory one block may take on the H100
# kernel A: bands of WIDE_W stripes and more run the wide row
# (csrc/banded8_wide.cu, one block of 16 lanes x K threads a pair), below it
# the narrow row (csrc/banded8.cu, one half-warp a pair)
WIDE_W = 32
WIDE_SCALAR_BYTES = 4 * 1208   # the wide row's shared scalars (NSCALAR)

# edit: bands past EDIT_REG_NW words (16,384 bits) run the block row (one
# block of warps a pair, csrc/edit.cu edit_blk_rows_kernel) up to
# EDIT_BLOCK_MAX_NW words (16 warps of threads owning 8 words); past it the
# cluster row (one thread-block cluster of such blocks a pair,
# edit_cl_rows_kernel), the band in registers while EDIT_CLUSTER_MAX blocks
# (EDIT_CLUSTER_MAX_NP where the card takes that non-portable size) hold
# it, past that swept in pieces from state rows in device memory
# (edit_cl_sweep_kernel)
EDIT_REG_NW = 512
EDIT_BLOCK_MAX_NW = 4096
EDIT_BLOCK_MAXW = 16
EDIT_CLUSTER_MAX = 8      # the portable cluster size
EDIT_CLUSTER_MAX_NP = 16  # the non-portable one
EDIT_CLUSTER_WORDS = 1024  # words a block of the cluster row aims at
EDIT_SWEEP_MAXW = 8       # warps of the sweep's blocks at most
EDIT_DESIGNS = {"register": 0, "block": 1, "cluster": 3}
# pedit: bands past PEDIT_REG_BW cells run the block row (one block of
# warps a job, csrc/pedit.cu pedit_blk_rows_kernel), its ring of 2 bytes a
# position (a power of two >= 2 rows + 32) in shared memory: bw + 2 <=
# 32,512
PEDIT_REG_BW = 1022
PEDIT_MAX_BW = 32510
PEDIT_BLOCK_MAXW = 32
PEDIT_DESIGNS = ("register", "block")
# the block rows' warp limits reach the kernels (their launch bounds and
# shared arrays) from here, as defines
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", f"-DEDIT_BLK_MAXW={EDIT_BLOCK_MAXW}",
              f"-DEDIT_SWP_MAXW={EDIT_SWEEP_MAXW}",
              f"-DPEDIT_BLK_MAXW={PEDIT_BLOCK_MAXW}"]

# kernel launches of bsa_banded8_rows (the narrow row) and of
# bsa_banded8_wide_rows (the wide row) in this process, by emit
launches_codes = 0
launches_planes = 0
launches_none = 0
launches_wide_codes = 0
launches_wide_planes = 0
launches_wide_none = 0
edit_launches = 0     # kernel launches of bsa_edit_rows in this process
edit_block_launches = 0   # those of the block row
edit_cluster_launches = 0  # those of the cluster row
edit_sweep_launches = 0    # those of them that sweep (past its registers)
pedit_launches = 0    # kernel launches of bsa_pedit_rows in this process
pedit_block_launches = 0  # those of the block row
build_seconds = 0.0
_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def lib():
    """The loaded kernel library, built on first use (raises on failure)."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            path, build_seconds = build_shared(
                "kernels", srcs, [_nvcc()] + NVCC_FLAGS, [_nvcc(), "-shared"],
                deps=sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
            so = ctypes.CDLL(path)
            so.bsa_banded8_rows.argtypes = \
                [ctypes.c_void_p] * 25 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
            so.bsa_banded8_rows.restype = ctypes.c_int
            so.bsa_banded8_wide_rows.argtypes = \
                [ctypes.c_void_p] * 26 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
            so.bsa_banded8_wide_rows.restype = ctypes.c_int
            so.bsa_edit_rows.argtypes = \
                [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 \
                + [ctypes.c_void_p]
            so.bsa_edit_rows.restype = ctypes.c_int
            so.bsa_edit_cluster_occupancy.argtypes = [ctypes.c_int] * 5
            so.bsa_edit_cluster_occupancy.restype = ctypes.c_int
            so.bsa_edit_cluster_floor.argtypes = \
                [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
            so.bsa_edit_cluster_floor.restype = ctypes.c_int
            so.bsa_pedit_rows.argtypes = \
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            so.bsa_pedit_rows.restype = ctypes.c_int
            _LIB = so
    return _LIB


def _check(name, t, shape, kernel="banded8"):
    if t.device.type != "cuda" or t.dtype != torch.int32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous int32 "
                         f"CUDA tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


EMIT_CODE = {"codes": 0, "planes": 1, "none": 2}
# phases of the kernel's optional cycle split, in the order of its rows
SPLIT_PHASES = ("move", "head", "pass1", "floop", "pass2", "steer", "emit")


def wide_lanes(W):
    """Threads a lane of the wide kernel: the smallest power of two from 2
    (whole warps) to 32 (one warp a lane, from W 129 on) whose runs of 8
    stripes cover the lane."""
    return min(32, max(2, 1 << (-(-W // 8) - 1).bit_length()))


def wide_geometry(W, K):
    """(R, n): each of a lane's K threads owns a run of R stripes, a
    multiple of 8 and an odd number of 8-byte words (the lane's threads
    then read shared memory without bank conflicts); n threads of the lane
    have stripes."""
    words = -(-W // 8)
    R = 8 * (-(-words // K) | 1)
    return R, -(-W // R)


def banded8_wide_store_bytes(W, piecewise):
    """Bytes of the wide kernel's plane store for its one pair: two
    buffers of piecewise + 1 planes in natural band order, each the band
    rounded up to 8 bytes plus one word that unaligned reads may touch."""
    return 2 * (piecewise + 1) * (-(-W * WS // 8) * 8 + 8)


def banded8_store_bytes(W, piecewise, pairs=PAIRS_PER_BLOCK):
    """Bytes of the banded-8 kernel's plane store for `pairs` pairs: two
    buffers of piecewise + 1 planes of 16 lanes, each lane's W stripes
    padded to an odd number of 8-byte words."""
    return pairs * 2 * (piecewise + 1) * WS * 8 * (-(-W // 8) | 1)


def banded8_rows(g, st, *, cycle_split=False, store=None, design=None,
                 count_replays=False):
    """Launch kernel A for geometry g (its emit: codes, planes or none) on
    state st (a banded8.State on one CUDA device, resumed at st.row0 from
    st.reg). Returns the raw outputs as device tensors, with the keys of
    banded8.forward_plain. With cycle_split, out["cycles"] is an int64
    [len(SPLIT_PHASES), B] tensor: each pair's SM clock cycles per phase,
    summed over its rows below tlen (the main paths never ask).

    `design` picks the row: None (every main path) the wide row for
    W >= WIDE_W and the narrow row below; "narrow" or "wide" forces one
    (tests hold the two against each other). With count_replays (the wide
    row only), out["replays"] is the int32 [B] count of each pair's rows
    whose scan was proven wrong and replayed.

    `store` says where the band's planes live: None (every main path)
    takes shared memory when a block's planes fit SMEM_MAX and else a
    scratch in device memory; "shared" or "global" forces one."""
    global launches_codes, launches_planes, launches_none
    global launches_wide_codes, launches_wide_planes, launches_wide_none
    pw = g.piecewise
    if g.emit not in EMIT_CODE or pw not in (0, 1, 2) \
            or (g.emit == "codes" and pw == 2):
        raise NotImplementedError(f"the banded-8 kernel has no emit "
                                  f"{g.emit!r} at piecewise {pw}")
    B, QP = st.qpad.shape
    T, W, BW = g.T, g.W, g.BW
    if design is None:
        design = "wide" if W >= WIDE_W else "narrow"
    if design not in ("narrow", "wide") or (count_replays
                                            and design != "wide"):
        raise ValueError(f"banded8 kernel: design {design!r}, "
                         f"count_replays {count_replays}")
    wide = design == "wide"
    dev = st.qpad.device
    _check("qpad", st.qpad, (B, QP))
    _check("tseq", st.tseq, (B, T))
    for name in ("qlen", "tlen", "rbz"):
        _check(name, getattr(st, name), (B,))
    _check("rby", st.rby, (T, B))
    _check("mtx5", st.mtx5, (5, 4))
    _check("us", st.us, (W, WS, B))
    _check("ub", st.ub, (WS + 1, B))
    _check("reg", st.reg, (8, B))
    if pw >= 1:
        _check("es", st.es, (W, WS, B))
    if pw == 2:
        _check("qs", st.qs, (W, WS, B))
    planes = banded8_wide_store_bytes(W, pw) if wide \
        else banded8_store_bytes(W, pw)
    smem = planes + (WIDE_SCALAR_BYTES if wide else 0)
    if store is None:
        store = "shared" if smem <= SMEM_MAX else "global"
    if store not in ("shared", "global") or (store == "shared"
                                             and smem > SMEM_MAX):
        raise ValueError(f"banded8 kernel: store {store!r} at band {BW} "
                         f"({smem} bytes of shared memory a block)")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(fin_planes=[empty(W, WS, B) for _ in range(pw + 1)],
               fin_ub=empty(WS + 1, B), fin_reg=empty(8, B))
    if g.emit != "none":
        out["begs"] = empty(T, B)
    if g.emit == "codes":
        out["codes"] = empty(T, g.CPW, WS, B)
    elif g.emit == "planes":
        out["us"] = empty(T, BW, B, dtype=torch.int8)
        out["es"] = empty(T, BW, B, dtype=torch.int8) if pw >= 1 else None
        out["qs"] = empty(T, BW, B, dtype=torch.int8) if pw == 2 else None
        out["ubegs"] = empty(T, WS + 1, B)
    mt = mode_type(g.mode)
    mt = 0 if mt == MODE_GLOBAL else (1 if mt == MODE_OVERLAP else 2)
    d_oh, c_oh = g.overhang()
    qb = query_bytes(st.qpad)
    fin = out["fin_planes"] + [None] * (2 - pw)
    cycles = torch.zeros(len(SPLIT_PHASES), B, dtype=torch.int64,
                         device=dev) if cycle_split else None
    replays = torch.zeros(B, dtype=torch.int32, device=dev) \
        if count_replays else None
    if wide:   # one slot a pair
        gs = empty(planes * B, dtype=torch.int8) if store == "global" \
            else None
    else:      # one slot per pair of the grid's blocks, a missing one's too
        slots = -(-B // PAIRS_PER_BLOCK) * PAIRS_PER_BLOCK
        gs = empty(banded8_store_bytes(W, pw, slots), dtype=torch.int8) \
            if store == "global" else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    operands = (
        ptr(qb), ptr(st.tseq), ptr(st.qlen), ptr(st.tlen), ptr(st.rbz),
        ptr(st.rby), ptr(st.mtx5), ptr(st.us),
        ptr(st.es if pw >= 1 else None), ptr(st.qs if pw == 2 else None),
        ptr(st.ub), ptr(st.reg),
        *(ptr(out.get(k)) for k in ("codes", "us", "es", "qs", "ubegs",
                                    "begs")),
        *(ptr(t) for t in fin), ptr(out["fin_ub"]), ptr(out["fin_reg"]),
        ptr(cycles))
    shape = (B, qb.shape[1], T, int(st.row0), W, mt, pw, EMIT_CODE[g.emit],
             g.gapo1, g.gape1, g.gapo2, g.gape2, d_oh, c_oh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wide:
            K = wide_lanes(W)
            rc = lib().bsa_banded8_wide_rows(
                *operands, ptr(replays), ptr(gs), *shape, K,
                wide_geometry(W, K)[0], stream)
        else:
            rc = lib().bsa_banded8_rows(*operands, ptr(gs), *shape,
                                        PAIRS_PER_BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"banded8 {design} kernel launch failed: CUDA "
                           f"error {rc}")
    if wide:
        if g.emit == "codes":
            launches_wide_codes += 1
        elif g.emit == "planes":
            launches_wide_planes += 1
        else:
            launches_wide_none += 1
    elif g.emit == "codes":
        launches_codes += 1
    elif g.emit == "planes":
        launches_planes += 1
    else:
        launches_none += 1
    if cycle_split:
        out["cycles"] = cycles
    if count_replays:
        out["replays"] = replays
    return out


def edit_block_geometry(NW):
    """(K, warps) of the edit kernel's block row at NW words: each thread
    owns K consecutive words (4 up to NW 2,048, then 8), the block's warps
    cover the band; None past EDIT_BLOCK_MAX_NW (16 warps of 8 words)."""
    if NW > EDIT_BLOCK_MAX_NW:
        return None
    K = 4 if NW <= 32 * EDIT_BLOCK_MAXW * 4 else 8
    return K, -(-NW // (32 * K))


def edit_geometry_ok(NW, K, nwarp):
    """Whether the block row can run NW words as nwarp warps of threads
    owning K words each."""
    return K in (4, 8) and 1 <= nwarp <= EDIT_BLOCK_MAXW \
        and 32 * nwarp * K >= NW


def edit_cluster_geometry(NW, max_blocks=EDIT_CLUSTER_MAX, pairs=1,
                          sms=132):
    """(K, warps, C, pieces) of the edit kernel's cluster row at NW words
    for `pairs` pairs on a card of `sms` SMs. In registers (pieces 1): C
    blocks, at least the fewest (and 2) whose blocks of up to
    EDIT_BLOCK_MAXW warps of 8 words hold the band, more while each keeps
    EDIT_CLUSTER_WORDS words and the pairs' clusters fit the SMs, at most
    max_blocks (the fastest measured, PERF.md §6: with few pairs more
    blocks of about 1,024 words, with many the fewest); each block's share
    held as the block row would hold it (K 4 to 2,048 words, then 8), one
    block where the band fits one warp's. Past max_blocks blocks of 16
    warps of 8 words, the sweep: the fewest pieces of 8 words a thread
    that max_blocks blocks of EDIT_SWEEP_MAXW warps hold, and the blocks
    of that size the band needs."""
    full = 32 * EDIT_BLOCK_MAXW * 8        # words of a block of 8 a thread
    C = max(2, -(-NW // full))
    if C <= max_blocks:
        C = max(C, min(max_blocks, sms // max(pairs, 1),
                       -(-NW // EDIT_CLUSTER_WORDS)))
        K, nwarp = edit_block_geometry(-(-NW // C))
        return K, nwarp, -(-NW // (32 * nwarp * K)), 1
    piece = 32 * EDIT_SWEEP_MAXW * 8
    pieces = -(-NW // (max_blocks * piece))
    return 8, EDIT_SWEEP_MAXW, -(-NW // (pieces * piece)), pieces


def edit_cluster_geometry_ok(NW, K, nwarp, C, pieces=1):
    """Whether the cluster row can run NW words as C blocks of nwarp warps
    of threads owning `pieces` pieces of K words each (the sweep where
    pieces > 1: K 8, at most EDIT_SWEEP_MAXW warps), every block holding
    words of the band."""
    S = 32 * nwarp * K * pieces
    return K in (4, 8) and 1 <= nwarp <= EDIT_BLOCK_MAXW \
        and 1 <= C <= EDIT_CLUSTER_MAX_NP and pieces >= 1 \
        and (pieces == 1 or (K == 8 and nwarp <= EDIT_SWEEP_MAXW)) \
        and C * S >= NW > (C - 1) * S


_cluster_geo = {}


def edit_cluster_default(NW, pairs, dev):
    """The cluster row's geometry at NW words for `pairs` pairs on CUDA
    device `dev`: edit_cluster_geometry with the card's largest cluster and
    its SMs, fewer blocks a cluster while the card cannot hold the pairs'
    clusters at once (edit_cluster_occupancy) and the band allows."""
    idx = torch.device(dev).index
    key = (NW, pairs, torch.cuda.current_device() if idx is None else idx)
    if key not in _cluster_geo:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        least = max(2, -(-NW // (32 * EDIT_BLOCK_MAXW * 8)))
        maxc = edit_cluster_max(dev)
        while True:
            geo = edit_cluster_geometry(NW, maxc, pairs, sms)
            if geo[3] > 1 or geo[2] <= least:
                break
            with torch.cuda.device(dev):
                if edit_cluster_occupancy(*geo[:3]) >= pairs:
                    break
            maxc = geo[2] - 1
        _cluster_geo[key] = geo
    return _cluster_geo[key]


_cluster_max = {}


def edit_cluster_max(dev):
    """The most blocks a cluster row takes on CUDA device `dev`:
    EDIT_CLUSTER_MAX_NP where the card holds such a cluster of 16 warps of
    8 words (cudaOccupancyMaxActiveClusters), else EDIT_CLUSTER_MAX."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _cluster_max:
        with torch.cuda.device(idx):
            n = edit_cluster_occupancy(8, EDIT_BLOCK_MAXW,
                                       EDIT_CLUSTER_MAX_NP)
        _cluster_max[idx] = EDIT_CLUSTER_MAX_NP if n > 0 \
            else EDIT_CLUSTER_MAX
    return _cluster_max[idx]


def edit_cluster_occupancy(K, nwarp, C, NW=None, NWQ=0):
    """Clusters of the cluster row (C blocks of nwarp warps of K words in
    registers, the shared memory of a pair of NW words and NWQ query words)
    that the current card holds at once, or minus the CUDA error with which
    it refuses that size."""
    NW = C * 32 * nwarp * K if NW is None else NW
    return lib().bsa_edit_cluster_occupancy(K, nwarp, C, NW, NWQ)


def edit_cluster_floor(C, nwarp, pairs, rows, dev):
    """Launch the cluster exchange alone (csrc/edit.cu edit_cl_floor_kernel:
    per row one word into each block of the cluster and one cluster
    barrier) on `pairs` clusters of C blocks of nwarp warps: a probe of the
    exchange's floor for chip_smoke.py, on no main path."""
    out = torch.empty(C * pairs, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_edit_cluster_floor(C, nwarp, pairs, rows,
                                          out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"edit cluster floor launch failed: CUDA error "
                           f"{rc}")
    return out


def edit_design(NW):
    """The row the edit kernel runs at NW words when no design is
    forced."""
    if NW <= EDIT_REG_NW:
        return "register"
    return "block" if NW <= EDIT_BLOCK_MAX_NW else "cluster"


def edit_rows(g, ops, design=None, geometry=None):
    """Launch the edit kernel for geometry g (ops.edit.Geometry) on the
    operands ops (ops.edit.Operands, on one CUDA device). Returns the raw
    outputs as device tensors: pm, pp, sbeg, fin_pm, fin_pp, scal.

    `design` picks the row: None (every main path) edit_design(NW);
    "register" (NW <= EDIT_REG_NW), "block" (NW <= EDIT_BLOCK_MAX_NW) or
    "cluster" forces one (tests and chip_smoke.py hold them against each
    other). `geometry` forces the block row's (K, warps), by default
    edit_block_geometry(NW), or the cluster row's (K, warps, C) or (K,
    warps, C, pieces), by default edit_cluster_default(NW, pairs) (tests
    and chip_smoke.py time the others)."""
    global edit_launches, edit_block_launches, edit_cluster_launches
    global edit_sweep_launches
    _, B, NWQ = ops.qeq.shape
    T, NW = g.T, g.NW
    _check("qeq", ops.qeq, (4, B, NWQ), "edit")
    _check("tseq", ops.tseq, (B, T), "edit")
    for name in ("qlen", "tlen"):
        _check(name, getattr(ops, name), (B,), "edit")
    for name in ("rbegs", "movxs"):
        _check(name, getattr(ops, name), (T, B), "edit")
    dev = ops.qeq.device
    if design is None:
        design = edit_design(NW)
    if design not in EDIT_DESIGNS:
        raise ValueError(f"edit kernel: no {design!r} row")
    if geometry is not None:
        geo = tuple(geometry) + ((1,) if design == "cluster"
                                 and len(geometry) == 3 else ())
    elif design == "cluster":
        geo = edit_cluster_default(NW, B, dev)
    else:
        geo = edit_block_geometry(NW)
    if (design == "register" and NW > EDIT_REG_NW) \
            or (design == "block" and (geo is None or len(geo) != 2
                                       or not edit_geometry_ok(NW, *geo))) \
            or (design == "cluster" and (
                len(geo) != 4 or not edit_cluster_geometry_ok(NW, *geo))):
        raise ValueError(f"edit kernel: no {design!r} row at NW {NW}"
                         + ("" if geometry is None else f", {geometry}"))
    if geometry is not None and design == "register":
        raise ValueError("edit kernel: a geometry for the register row")
    K, nwarp, ncl, pieces = (geo + (0, 0))[:4] if design != "register" \
        else (0, 0, 0, 0)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = dict(pm=empty(B, T, NW), pp=empty(B, T, NW), sbeg=empty(B, T),
               fin_pm=empty(B, NW), fin_pp=empty(B, NW), scal=empty(B, 4))
    # the sweep's two state rows, 4 planes of its cluster's words a pair
    state = empty(B, 4 * ncl * 32 * nwarp * pieces * K) if pieces > 1 \
        else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_edit_rows(
            ops.qeq.data_ptr(), ops.qlen.data_ptr(), ops.tseq.data_ptr(),
            ops.tlen.data_ptr(), ops.rbegs.data_ptr(), ops.movxs.data_ptr(),
            *(out[k].data_ptr() for k in ("pm", "pp", "sbeg", "fin_pm",
                                          "fin_pp", "scal")),
            None if state is None else state.data_ptr(),
            B, T, NW, NWQ, mode_type(g.mode), EDIT_DESIGNS[design], K,
            nwarp, ncl, pieces, stream)
    if rc != 0:
        raise RuntimeError(f"edit {design} kernel launch failed: CUDA error "
                           f"{rc}")
    edit_launches += 1
    if design == "block":
        edit_block_launches += 1
    elif design == "cluster":
        edit_cluster_launches += 1
        edit_sweep_launches += pieces > 1
    return out


def pedit_block_geometry(bw):
    """(K, warps) of the pedit kernel's block row at bw cells: thread t of
    32 * warps holds cells t + 32 * warps * k, k < K. K 4 on up to 16 warps
    (2,048 cells), then K 8, 16 and 32 on up to PEDIT_BLOCK_MAXW (8,192,
    16,384, 32,768 cells); below 65 cells K 2 on one warp (forced block
    rows only). Of the geometries `chip_smoke.py --kernels` times at bw
    1,024 to 32,510, with 6 and 64 jobs, these were the fastest (PERF.md
    §6). Every cell past the band then lies in a thread's last two cells
    (the kernel masks that word alone)."""
    for K, maxw in ((2, 1), (4, 16), (8, PEDIT_BLOCK_MAXW),
                    (16, PEDIT_BLOCK_MAXW), (32, PEDIT_BLOCK_MAXW)):
        if 32 * maxw * K >= bw:
            break
    return K, -(-bw // (32 * K))


def pedit_geometry_ok(bw, K, nwarp):
    """Whether the block row can run bw cells as nwarp warps of threads
    holding K cells each, every cell past the band in a thread's last
    two."""
    NT = 32 * nwarp
    return K in (2, 4, 8, 16, 32) and 1 <= nwarp <= PEDIT_BLOCK_MAXW \
        and NT * K >= bw and NT * (K - 2) <= bw


def pedit_rows(pk, out=None, design=None, geometry=None):
    """Launch the pedit kernel on the packed jobs pk (ops.pedit.Packed, on
    one CUDA device). Returns the two flat uint8 output matrices as device
    tensors; the kernel writes every byte of them, zero outside the rows
    each job computes. `out` may give the two matrices to write into
    (contiguous uint8 of pk.total bytes each, 16-byte aligned); by default
    they are allocated uninitialised.

    `design` picks the row: None (every main path) the register rows up to
    PEDIT_REG_BW cells and the block row past it; "register" (bw <= 1,022)
    or "block" forces one (tests and chip_smoke.py). `geometry` (K, warps)
    forces the block row's, which by default is pedit_block_geometry(bw)
    (tests and chip_smoke.py time the others)."""
    global pedit_launches, pedit_block_launches
    if pk.bw > PEDIT_MAX_BW:
        raise NotImplementedError(
            f"pedit band of {pk.bw} cells exceeds the kernel's limit of "
            f"{PEDIT_MAX_BW} (the block row's ring of 2 bytes a position, a "
            f"power of two >= 2 rows + 32, in {SMEM_MAX} bytes of shared "
            f"memory)")
    if design is None:
        design = "register" if pk.bw <= PEDIT_REG_BW else "block"
    if design not in PEDIT_DESIGNS or (design == "register"
                                       and pk.bw > PEDIT_REG_BW):
        raise ValueError(f"pedit kernel: no {design!r} row at bw {pk.bw}")
    if geometry is not None and (design != "block"
                                 or not pedit_geometry_ok(pk.bw, *geometry)):
        raise ValueError(f"pedit kernel: no {design} row of geometry "
                         f"{geometry} at bw {pk.bw}")
    K, nwarp = ((pedit_block_geometry(pk.bw) if geometry is None
                 else tuple(geometry)) if design == "block" else (0, 0))
    for name, dt in (("rd", torch.uint8), ("cn", torch.uint8),
                     ("rdm", torch.uint8), ("cnm", torch.uint8),
                     ("jobs", torch.int64)):
        t = getattr(pk, name)
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pedit kernel: {name} must be a contiguous "
                             f"{dt} CUDA tensor, got {t.dtype} on {t.device}")
    J = pk.jobs.shape[0]
    if tuple(pk.jobs.shape) != (J, 8):
        raise ValueError(f"pedit kernel: jobs must be [J, 8], got "
                         f"{tuple(pk.jobs.shape)}")
    if pk.rdm.numel() != 4 * pk.rd.numel() \
            or pk.cnm.numel() != 4 * pk.cn.numel() \
            or (pk.rdm.data_ptr() | pk.cnm.data_ptr()) % 4:
        raise ValueError("pedit kernel: rdm / cnm must hold 4 aligned "
                         "bytes per byte of rd / cn")
    dev = pk.rd.device
    if out is None:
        out = tuple(torch.empty(pk.total, dtype=torch.uint8, device=dev)
                    for _ in range(2))
    for t in out:
        if t.device != dev or t.dtype != torch.uint8 \
                or not t.is_contiguous() or t.numel() != pk.total \
                or t.data_ptr() % 16:
            raise ValueError(f"pedit kernel: each output must be a "
                             f"contiguous, 16-byte aligned uint8 tensor of "
                             f"{pk.total} bytes on {dev}")
    out0, out1 = out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_pedit_rows(
            pk.rd.data_ptr(), pk.cn.data_ptr(), pk.rdm.data_ptr(),
            pk.cnm.data_ptr(), pk.jobs.data_ptr(), out0.data_ptr(),
            out1.data_ptr(), J, pk.bw, pk.HW, PEDIT_DESIGNS.index(design), K,
            nwarp, stream)
    if rc != 0:
        raise RuntimeError(f"pedit {design} kernel launch failed: CUDA "
                           f"error {rc}")
    pedit_launches += 1
    if design == "block":
        pedit_block_launches += 1
    return out0, out1


def to_host_async(raw, inputs):
    """Queue copies of the raw outputs (tensors, lists of tensors or None)
    into pinned host memory behind the launch on the current stream, with
    an event that marks their end. The launch's input tensors are held
    until the event has been waited for."""
    def cp(t):
        if t is None:
            return None
        if isinstance(t, list):
            return [cp(x) for x in t]
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    out = {k: cp(v) for k, v in raw.items()}
    ev = torch.cuda.Event()
    ev.record()
    out["_event"] = ev
    out["_inputs"] = inputs
    return out


def wait_host(host):
    """Wait for one launch's copies alone (later launches keep running)."""
    host = dict(host)
    host.pop("_event").synchronize()
    del host["_inputs"]
    return host
