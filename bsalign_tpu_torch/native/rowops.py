"""ctypes wrapper of the native codes walker (port of
bsalign_tpu.native.rowops.decode_codes)."""
from __future__ import annotations

import numpy as np

from . import rowops_lib


def decode_codes(qseq, tseq, codes_w, begs_p, init_eo, b, is_overlap,
                 bandwidth, rs):
    """Walk pair b's packed 4-bit traceback codes (codes_w [T, CPW, WS, B]
    int32 and begs_p [T, B] int32, both C-contiguous numpy); mutates `rs`
    (AlnResult) and returns the packed CIGAR list."""
    lib = rowops_lib()
    T, CPW, _, B = codes_w.shape
    stats = np.zeros(10, np.int64)
    stats[0] = rs.score
    stats[2] = rs.qe
    stats[4] = rs.te
    cg_cap = int(qseq.size + tseq.size + 8)
    cg = np.zeros(cg_cap, np.uint32)
    qc = np.ascontiguousarray(qseq, np.uint8)
    tc = np.ascontiguousarray(tseq, np.uint8)
    eo = np.ascontiguousarray(init_eo, np.uint8)
    n = lib.bsa_decode_codes(
        qc.ctypes.data, tc.ctypes.data, codes_w.ctypes.data, CPW,
        begs_p.ctypes.data, eo.ctypes.data, B, b, int(is_overlap),
        bandwidth, stats.ctypes.data, cg.ctypes.data, cg_cap)
    if n > cg_cap:
        raise RuntimeError("cigar overflow")
    (rs.score, rs.qb, rs.qe, rs.tb, rs.te, rs.mat, rs.mis, rs.ins,
     rs.dele, rs.aln) = (int(x) for x in stats)
    return [int(x) for x in cg[:n]]
