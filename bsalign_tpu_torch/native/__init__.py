"""Host walker of the packed traceback codes, bound with ctypes.

The walker is `rowops.cpp` in this directory (`bsa_decode_codes`), the
port's own copy of the JAX package's host C++, kept unchanged so that the
two packages' CIGARs stay byte-identical. The library is built with
`g++ -O3 -fPIC` and linked with `g++ -shared` into this package's build
directory on first use.
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


def rowops_lib():
    """The loaded walker library, built on first use (raises on failure)."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path, build_seconds = build_shared(
                "rowops", [SOURCE], ["g++", "-O3", "-fPIC"],
                ["g++", "-shared"])
            lib = ctypes.CDLL(path)
            lib.bsa_decode_codes.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ]
            lib.bsa_decode_codes.restype = ctypes.c_long
            _LIB = lib
    return _LIB
