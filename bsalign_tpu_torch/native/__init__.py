"""Host C++ of the port, bound with ctypes.

The library is `rowops.cpp` in this directory, the port's own copy of the
JAX package's host C++, kept unchanged so that the two packages' CIGARs,
MSAs and consensus stay byte-identical. It holds the tracebacks of
`align` (the codes walker `bsa_decode_codes`, its resumable row-chunk
form `bsa_walk_codes_chunk` and the planes walk `bsa8_backcal`) and the
POA engine's graph, row-DP, MSA,
consensus and pedit-traceback entry points (wrapped in `rowops.py`). It is
built with `g++ -O3 -fPIC` and linked with `g++ -shared` into this
package's build directory on first use; a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading

from ..utils.build import build_shared

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rowops.cpp")

_LOCK = threading.Lock()
_LIB = None
build_seconds = 0.0

_P = ctypes.c_void_p
_L = ctypes.c_long
_GFULL = [_P] * 17     # the graph's SoA pointer pack (rowops.cpp GFULL_ARGS)

# name: (argtypes, restype)
_SIGNATURES = {
    "bsa_decode_codes": (
        [_P, _P, _P, ctypes.c_int, _P, _P, _L, _L, ctypes.c_int,
         ctypes.c_int, _P, _P, _L], _L),
    "bsa8_backcal": (
        [_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, _L, _L]
        + [ctypes.c_int] * 2 + [_P] + [ctypes.c_int] * 5 + [_P, _P, _L], _L),
    "bsa_walk_codes_chunk": (
        [_P, _P, _P, _P, _P, ctypes.c_int, _P, _P, _P, _L, _L, _L,
         ctypes.c_int, ctypes.c_int, _P, _P, _L], _L),
    "bsa_align_rd_core": (
        [_P] * 12 + [_L] + [_P] * 8 + [_L] * 15 + [_P, _P, _L], _L),
    "bsa_pedit_forward": (
        [_P] * 6 + [ctypes.c_int] * 6 + [_L], None),
    "bsa_pedit_traceback": ([_P] * 24 + [_L] * 9, _L),
    "bsa_sort_nodes": ([_P] * 11 + [_L] * 3 + [_P, _L], _L),
    "bsa_msa_fill": ([_P] * 11 + [_L] * 3 + [_P, _P, _L, _L, _P, _L], _L),
    "bsa_mask_lead_tail": ([_P, _P, _L, _L, _L], None),
    "bsa_alignment2graph": ([_P] * 33 + [_L] * 16 + [_P], _L),
    "bsa_msanode_cns_merges": ([_P] * 20 + [_L] * 4 + [_P, _L], _L),
    "bsa_msanode_rail_merges": ([_P] * 20 + [_L] * 4 + [_P], _L),
    "bsa_sel_nodes": ([_P] * 22 + [_L] * 6 + [_P, _P, _L, _P, _L, _P], _L),
    "bsa_align_rd_full": ([_P] * 27 + [_L] * 3 + [_P] * 2 + [_L] * 19 + [_P],
                          _L),
    "bsa_end_begin_loop": ([_P] * 31 + [_L] * 19 + [_P, _L, _L, _P, _L, _P,
                                                    _L, _P], _L),
    "bsa_cns_forward": (
        [_P, _L, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_double, _P, _P,
         _P], None),
    "bsa_cns_tail": (
        [_P, _P, _P, _L, _P, _L, _L, _L, ctypes.c_double, _L, _P, _P, _P, _P],
        _L),
    "bsa_hp_adjust": ([_L, _P, _P, _L], None),
    "bsa_edit_align": ([_P, _L, _P, _L, _L, _L, _P, _L, _P], _L),
    "bsa_kmer_edit": ([_P, _L, _P, _L, _L, _P, _L, _P], _L),
    "bsa_qprof4": ([_P] + [_L] * 5 + [_P] * 4, None),
    "bsa_simple_cns": ([_P, _P, _L, _L, _L, _L, _P, _P, _P], _L),
    "bsa_gf_chg_edge": (_GFULL + [_L] * 3, _L),
    "bsa_g_cut_rdnode": (_GFULL + [_L] * 3, _L),
    "bsa_g_merge_nodes": (_GFULL + [_L] * 2, _L),
    "bsa_g_cut_range": (_GFULL + [_L] * 5, _L),
    "bsa_g_cut_range_asc": (_GFULL + [_L] * 5, _L),
    "bsa_g_connect_range": (_GFULL + [_L] * 3, _L),
    "bsa_g_connect": (_GFULL + [_L] * 2, _L),
    "bsa_g_disconnect": (_GFULL + [_L] * 2, _L),
}


def rowops_lib():
    """The loaded host library, built on first use (raises on failure)."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path, build_seconds = build_shared(
                "rowops", [SOURCE], ["g++", "-O3", "-fPIC"],
                ["g++", "-shared"])
            lib = ctypes.CDLL(path)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _LIB = lib
    return _LIB
