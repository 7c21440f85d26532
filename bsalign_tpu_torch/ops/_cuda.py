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

WS = WORDSIZE
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
PAIRS_PER_BLOCK = 2   # one warp per block: 256 pairs spread over 128 SMs

EDIT_MAX_NW = 512     # widest edit band the kernel is built for (16384 bits)
PEDIT_MAX_BW = 1022   # widest pedit band: bw + 2 cells, one thread each

launches = 0          # kernel launches of bsa_banded8_codes in this process
edit_launches = 0     # kernel launches of bsa_edit_rows in this process
pedit_launches = 0    # kernel launches of bsa_pedit_rows in this process
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
                "kernels", srcs, [_nvcc()] + NVCC_FLAGS, [_nvcc(), "-shared"])
            so = ctypes.CDLL(path)
            so.bsa_banded8_codes.argtypes = \
                [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            so.bsa_banded8_codes.restype = ctypes.c_int
            so.bsa_edit_rows.argtypes = \
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            so.bsa_edit_rows.restype = ctypes.c_int
            so.bsa_pedit_rows.argtypes = \
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            so.bsa_pedit_rows.restype = ctypes.c_int
            _LIB = so
    return _LIB


def _check(name, t, shape, kernel="banded8"):
    if t.device.type != "cuda" or t.dtype != torch.int32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} must be a contiguous int32 "
                         f"CUDA tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def banded8_codes(g, st):
    """Launch the banded-8 codes kernel for geometry g on state st (a
    banded8.State on one CUDA device). Returns the raw outputs as device
    tensors: codes, begs, fin_planes, fin_ub, fin_reg."""
    global launches
    if g.piecewise not in (0, 1) or not g.codes:
        raise NotImplementedError("the banded-8 kernel emits codes for "
                                  "piecewise 0/1 only")
    B, QP = st.qpad.shape
    T, W = g.T, g.W
    dev = st.qpad.device
    _check("qpad", st.qpad, (B, QP))
    _check("tseq", st.tseq, (B, T))
    for name in ("qlen", "tlen", "rbz"):
        _check(name, getattr(st, name), (B,))
    _check("rby", st.rby, (T, B))
    _check("mtx5", st.mtx5, (5, 4))
    _check("us", st.us, (W, WS, B))
    _check("ub", st.ub, (WS + 1, B))
    if g.piecewise:
        _check("es", st.es, (W, WS, B))
    smem = PAIRS_PER_BLOCK * 4 * W * WS
    if smem > 227 * 1024:
        raise NotImplementedError(f"band {g.BW} needs {smem} bytes of shared "
                                  "memory per block, above the card's 227 KB")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    codes = empty(T, g.CPW, WS, B)
    begs = empty(T, B)
    fin_us = empty(W, WS, B)
    fin_es = empty(W, WS, B) if g.piecewise else None
    fin_ub = empty(WS + 1, B)
    fin_reg = empty(8, B)
    mt = mode_type(g.mode)
    d_oh, c_oh = g.overhang()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_banded8_codes(
            ptr(st.qpad), ptr(st.tseq), ptr(st.qlen), ptr(st.tlen),
            ptr(st.rbz), ptr(st.rby), ptr(st.mtx5), ptr(st.us),
            ptr(st.es if g.piecewise else None), ptr(st.ub), ptr(codes),
            ptr(begs), ptr(fin_us), ptr(fin_es), ptr(fin_ub), ptr(fin_reg),
            B, QP, T, W, 0 if mt == MODE_GLOBAL else
            (1 if mt == MODE_OVERLAP else 2), g.piecewise, g.gapo1, g.gape1,
            g.gape2, d_oh, c_oh, PAIRS_PER_BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"banded8 kernel launch failed: CUDA error {rc}")
    launches += 1
    return dict(codes=codes, begs=begs,
                fin_planes=[t for t in (fin_us, fin_es) if t is not None],
                fin_ub=fin_ub, fin_reg=fin_reg)


def edit_rows(g, ops):
    """Launch the edit kernel for geometry g (ops.edit.Geometry) on the
    operands ops (ops.edit.Operands, on one CUDA device). Returns the raw
    outputs as device tensors: pm, pp, sbeg, fin_pm, fin_pp, scal."""
    global edit_launches
    if g.NW > EDIT_MAX_NW:
        raise NotImplementedError(
            f"edit band of {g.NW} words ({g.bw} bits) exceeds the kernel's "
            f"limit of {EDIT_MAX_NW} words ({EDIT_MAX_NW * 32} bits)")
    _, B, NWQ = ops.qeq.shape
    T, NW = g.T, g.NW
    _check("qeq", ops.qeq, (4, B, NWQ), "edit")
    _check("tseq", ops.tseq, (B, T), "edit")
    for name in ("qlen", "tlen"):
        _check(name, getattr(ops, name), (B,), "edit")
    for name in ("rbegs", "movxs"):
        _check(name, getattr(ops, name), (T, B), "edit")
    dev = ops.qeq.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = dict(pm=empty(B, T, NW), pp=empty(B, T, NW), sbeg=empty(B, T),
               fin_pm=empty(B, NW), fin_pp=empty(B, NW), scal=empty(B, 4))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_edit_rows(
            ops.qeq.data_ptr(), ops.qlen.data_ptr(), ops.tseq.data_ptr(),
            ops.tlen.data_ptr(), ops.rbegs.data_ptr(), ops.movxs.data_ptr(),
            *(out[k].data_ptr() for k in ("pm", "pp", "sbeg", "fin_pm",
                                          "fin_pp", "scal")),
            B, T, NW, NWQ, mode_type(g.mode), stream)
    if rc != 0:
        raise RuntimeError(f"edit kernel launch failed: CUDA error {rc}")
    edit_launches += 1
    return out


def pedit_rows(pk):
    """Launch the pedit kernel on the packed jobs pk (ops.pedit.Packed, on
    one CUDA device). Returns the two flat uint8 output matrices as device
    tensors, zero outside the rows each job writes."""
    global pedit_launches
    if pk.bw > PEDIT_MAX_BW:
        raise NotImplementedError(
            f"pedit band of {pk.bw} cells exceeds the kernel's limit of "
            f"{PEDIT_MAX_BW} (one thread per cell, {PEDIT_MAX_BW + 2} cells "
            "per block)")
    for name, dt in (("rd", torch.uint8), ("cn", torch.uint8),
                     ("jobs", torch.int64)):
        t = getattr(pk, name)
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pedit kernel: {name} must be a contiguous "
                             f"{dt} CUDA tensor, got {t.dtype} on {t.device}")
    J = pk.jobs.shape[0]
    if tuple(pk.jobs.shape) != (J, 8):
        raise ValueError(f"pedit kernel: jobs must be [J, 8], got "
                         f"{tuple(pk.jobs.shape)}")
    dev = pk.rd.device
    out0 = torch.zeros(pk.total, dtype=torch.uint8, device=dev)
    out1 = torch.zeros(pk.total, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().bsa_pedit_rows(pk.rd.data_ptr(), pk.cn.data_ptr(),
                                  pk.jobs.data_ptr(), out0.data_ptr(),
                                  out1.data_ptr(), J, pk.bw, pk.HW, stream)
    if rc != 0:
        raise RuntimeError(f"pedit kernel launch failed: CUDA error {rc}")
    pedit_launches += 1
    return out0, out1


def to_host_async(raw, inputs):
    """Queue copies of the raw outputs into pinned host memory behind the
    launch on the current stream, with an event that marks their end. The
    launch's input tensors are held until the event has been waited for."""
    def cp(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    out = dict(codes=cp(raw["codes"]), begs=cp(raw["begs"]),
               fin_planes=[cp(t) for t in raw["fin_planes"]],
               fin_ub=cp(raw["fin_ub"]), fin_reg=cp(raw["fin_reg"]))
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
