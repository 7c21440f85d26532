"""ctypes wrappers of the host C++ (port of the parts of
bsalign_tpu.native.rowops that `align` and `poa` reach).

Arrays are C-contiguous NumPy arrays passed by address; the graph `g` is a
poa.graph.Graph, whose struct-of-arrays the C++ mutates in place.
"""
from __future__ import annotations

import numpy as np

from ..cigar import AlnResult
from ..oracle.banded8 import WS
from . import rowops_lib


def _stats_rs(stats, rs):
    (rs.score, rs.qb, rs.qe, rs.tb, rs.te, rs.mat, rs.mis, rs.ins,
     rs.dele, rs.aln) = (int(x) for x in stats)
    return rs


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
    _stats_rs(stats, rs)
    return [int(x) for x in cg[:n]]


def backcal(qseq, tseq, init_row, us_p, es_p, qs_p, ub_p, begs_p, b,
            is_overlap, bandwidth, mtx, gapo1, gape1, gapo2, gape2,
            piecewise, rs):
    """Walk pair b's stored u/e/q planes with the reference's backcal
    (bsalign.h:3704-3852): us_p/es_p/qs_p [T, BW, B] int8 (es_p and qs_p
    None below piecewise 1 and 2), ub_p [T, ubr, B] int32, begs_p [T, B]
    int32 and mtx [16] int8, all C-contiguous numpy. Mutates `rs`
    (AlnResult) and returns the packed CIGAR list."""
    lib = rowops_lib()
    T, BW, B = us_p.shape
    ubr = ub_p.shape[1]
    init_us = np.ascontiguousarray(init_row.us, np.int8)
    init_ub = np.ascontiguousarray(init_row.ubegs, np.int64)
    stats = np.zeros(10, np.int64)
    stats[0] = rs.score
    stats[2] = rs.qe
    stats[4] = rs.te
    cg_cap = int(qseq.size + tseq.size + 8)
    cg = np.zeros(cg_cap, np.uint32)
    qc = np.ascontiguousarray(qseq, np.uint8)
    tc = np.ascontiguousarray(tseq, np.uint8)
    n = lib.bsa8_backcal(
        qc.ctypes.data, len(qc), tc.ctypes.data, len(tc),
        init_us.ctypes.data, init_ub.ctypes.data, us_p.ctypes.data,
        None if es_p is None else es_p.ctypes.data,
        None if qs_p is None else qs_p.ctypes.data,
        ub_p.ctypes.data, ubr, begs_p.ctypes.data, B, b, int(is_overlap),
        bandwidth, mtx.ctypes.data, gapo1, gape1, gapo2, gape2, piecewise,
        stats.ctypes.data, cg.ctypes.data, cg_cap)
    if n > cg_cap:
        raise RuntimeError("cigar overflow")
    _stats_rs(stats, rs)
    return [int(x) for x in cg[:n]]


WK_NST = 12        # per-pair walk-state slots (rowops.cpp WK_* enum)
WK_QB, WK_TB, WK_PM, WK_DJ, WK_CG, WK_NCG = range(6)
WK_MAT, WK_MIS, WK_INS, WK_DEL, WK_ALN, WK_DONE = range(6, 12)
WK_NOJ = -(1 << 60)


def walk_init(qe, te):
    """Fresh walk-state array for the chunked codes walker: one row per
    pair, started at (qe, te) like bsa_decode_codes' entry point."""
    st = np.zeros((len(qe), WK_NST), np.int64)
    st[:, WK_QB] = qe
    st[:, WK_TB] = te
    st[:, WK_DJ] = WK_NOJ
    return st


def walk_codes_chunk(qflat, qoffs, tflat, toffs, codes_c, begs_c, beg_prev,
                     init_eo, t0, t1, is_overlap, bandwidth, st, cg_out):
    """Advance all pairs' tracebacks through band rows [t0, t1) of one
    re-forwarded chunk (codes_c [t1-t0, CPW, WS, B] int32 packed codes,
    begs_c [t1-t0, B], beg_prev [B] the band offset of row t0-1). Mutates
    st in place; the CIGAR words this call completes land in
    cg_out[b, :st[b, WK_NCG]] in walk order."""
    r = rowops_lib().bsa_walk_codes_chunk(
        qflat.ctypes.data, qoffs.ctypes.data, tflat.ctypes.data,
        toffs.ctypes.data, codes_c.ctypes.data, codes_c.shape[1],
        begs_c.ctypes.data, beg_prev.ctypes.data, init_eo.ctypes.data,
        st.shape[0], int(t0), int(t1), int(is_overlap), int(bandwidth),
        st.ctypes.data, cg_out.ctypes.data, cg_out.shape[1])
    if r != 0:
        raise RuntimeError("cigar overflow in chunked codes walk")


# ------------------------------------------------------------ POA graph
def gfull_args(g):
    """Cached pointer pack over the graph's SoA arrays (invalidated by the
    graph whenever an array rebinds)."""
    args = g._gargs
    if args is None:
        # the C GFULL view covers the first 11 topology arrays
        args = tuple(a.ctypes.data for a in g._nd[:11]) + \
            tuple(a.ctypes.data for a in g._ed) + \
            (g._estate.ctypes.data, g._ecyc.ctypes.data)
        g._gargs = args
    return args


def _check(r, what):
    if r < 0:
        raise RuntimeError(f"native {what} failed ({r})")
    return int(r)


def g_chg_edge(g, u, v, cov):
    """chg_edge over the graph's SoA arrays; returns (eidx, existed)."""
    r = _check(rowops_lib().bsa_gf_chg_edge(*gfull_args(g), u, v, cov),
               "chg_edge")
    return (r >> 1), (r & 1)


def g_cut_rdnode(g, nidx, cut):
    return _check(rowops_lib().bsa_g_cut_rdnode(*gfull_args(g), len(g.nodes),
                                                nidx, cut), "cut_rdnode")


def g_merge_nodes(g, n1, n2):
    return _check(rowops_lib().bsa_g_merge_nodes(*gfull_args(g), n1, n2),
                  "merge_nodes")


def g_connect(g, u, v):
    """Connect read nodes u -> v (bspoa.h connect_rdnode)."""
    _check(rowops_lib().bsa_g_connect(*gfull_args(g), u, v), "connect")


def g_disconnect(g, u, v):
    """Disconnect read nodes u -> v (bspoa.h disconnect_rdnode)."""
    _check(rowops_lib().bsa_g_disconnect(*gfull_args(g), u, v),
           "disconnect")


def g_cut_range(g, rid, lo, hi, cut):
    """cut_rdnode over positions hi-1..lo (descending)."""
    # worst-case edge growth per cut is bounded by local degree; size for
    # the whole range generously and grow the stack headroom once
    g._encap_edges(8 * (hi - lo) + 64)
    _check(rowops_lib().bsa_g_cut_range(*gfull_args(g), len(g.nodes),
                                        g.ndoffs[rid], lo, hi, cut),
           "cut_range")


def g_cut_range_asc(g, rid, lo, hi, cut):
    """cut_rdnode over positions lo..hi-1 (ascending; del_msanodes order)."""
    g._encap_edges(8 * (hi - lo) + 64)
    _check(rowops_lib().bsa_g_cut_range_asc(*gfull_args(g), len(g.nodes),
                                            g.ndoffs[rid], lo, hi, cut),
           "cut_range_asc")


def g_connect_range(g, rid, lo, hi):
    g._encap_edges(4 * (hi - lo + 1) + 64)
    _check(rowops_lib().bsa_g_connect_range(*gfull_args(g), g.ndoffs[rid],
                                            lo, hi), "connect_range")


# ------------------------------------------------------- POA alignment
class RowArena:
    """Contiguous row storage indexed by mmidx slot, read and written by
    the C++ row DP."""

    def __init__(self, nslot, W, piecewise):
        self.us = np.zeros((nslot, W, WS), np.int8)
        self.es = np.zeros((nslot, W, WS), np.int8) if piecewise else None
        self.qs = (np.zeros((nslot, W, WS), np.int8)
                   if piecewise == 2 else None)
        self.ub = np.zeros((nslot, WS + 1), np.int64)
        self.ptrs = (self.us.ctypes.data,
                     self.es.ctypes.data if piecewise else None,
                     self.qs.ctypes.data if piecewise == 2 else None,
                     self.ub.ctypes.data)

    def set_from(self, slot, st):
        self.us[slot] = st.us
        if self.es is not None:
            self.es[slot] = st.es
        if self.qs is not None:
            self.qs[slot] = st.qs
        self.ub[slot] = st.ubegs


def qprof4(qsub, slen, bandwidth, M, X, refbonus):
    """All four POA query profiles ({M, M+refbonus} x {hpc, plain}) in one
    call; each [xlen+1, 4, WS] int8."""
    qc = np.ascontiguousarray(qsub, np.uint8)
    xlen = max(slen, bandwidth)
    outs = [np.empty((xlen + 1, 4, WS), np.int8) for _ in range(4)]
    rowops_lib().bsa_qprof4(qc.ctypes.data, slen, bandwidth, M, X, refbonus,
                            outs[0].ctypes.data, outs[1].ctypes.data,
                            outs[2].ctypes.data, outs[3].ctypes.data)
    return outs


def sel_nodes(g, nhead, ntail, ridxbeg, ridxend, nseq, ndoffs_arr):
    """Node-subset selection; returns (sels, states_map, todels_pairs)."""
    from ..poa.graph import ND_BLESS, ND_BONUS, ND_NCT, ND_VST
    nd = g._nd
    n = len(g.nodes)
    g._encap_edges(4 * n + 1024)
    states = np.zeros(n, np.uint8)
    sels = np.zeros(n + 8, np.int32)
    todels = np.zeros(2 * n + 8, np.int64)
    out = np.zeros(2, np.int64)
    _check(rowops_lib().bsa_sel_nodes(
        *gfull_args(g), nd[ND_VST].ctypes.data, nd[ND_NCT].ctypes.data,
        nd[ND_BONUS].ctypes.data, nd[ND_BLESS].ctypes.data,
        ndoffs_arr.ctypes.data, n, nhead, ntail, ridxbeg, ridxend, nseq,
        states.ctypes.data, sels.ctypes.data, len(sels),
        todels.ctypes.data, len(todels), out.ctypes.data), "sel_nodes")
    nsel, ntd = int(out[0]), int(out[1])
    td = todels[:ntd]
    pairs = [(int(td[i]), int(td[i + 1])) for i in range(0, ntd, 2)]
    return sels[:nsel], states, pairs


def align_rd_core(g, sels_arr, states_map, arena, qprof_ptrs, W, bandwidth,
                  slen, piecewise, nt_max, nt_min, gapo1, gape1, gapo2,
                  gape2, parT, is_overlap, is_global, nhead, ntail, best):
    """Kahn-walk forward DP over the selected subgraph; mutates the node
    arrays, the row arena, and best=[score, idx, off] in place."""
    from ..poa.graph import (ED_NEXT, ED_NODE, ND_BASE, ND_BONUS, ND_EDGE,
                             ND_MMIDX, ND_MPOS, ND_NCT, ND_RPOS, ND_VST)
    nd = g._nd
    ed = g._ed
    stack_buf = np.zeros(len(sels_arr) + 8, np.int32)
    _check(rowops_lib().bsa_align_rd_core(
        nd[ND_MPOS].ctypes.data, nd[ND_VST].ctypes.data,
        nd[ND_NCT].ctypes.data, nd[ND_MMIDX].ctypes.data,
        nd[ND_BASE].ctypes.data, nd[ND_BONUS].ctypes.data,
        nd[ND_RPOS].ctypes.data, nd[ND_EDGE].ctypes.data,
        ed[ED_NODE].ctypes.data, ed[ED_NEXT].ctypes.data,
        states_map.ctypes.data, sels_arr.ctypes.data, len(sels_arr),
        arena.ptrs[0], arena.ptrs[1], arena.ptrs[2], arena.ptrs[3],
        qprof_ptrs[0], qprof_ptrs[1], qprof_ptrs[2], qprof_ptrs[3],
        W, bandwidth, slen, piecewise, nt_max, nt_min, gapo1, gape1,
        gapo2, gape2, parT, is_overlap, is_global, nhead, ntail,
        best.ctypes.data, stack_buf.ctypes.data, len(stack_buf)),
        "align_rd_core")


def alignment2graph(g, arena, qprof_ptrs, states_map, ndoffs_arr, W,
                    bandwidth, qlen, qb, piecewise, parO, parE, parQ, parP,
                    is_overlap, nhead, ntail, midx, xe, rid, rbeg, rs):
    """Graph traceback + ring fusion; fills rs (AlnResult)."""
    from ..poa.graph import (ND_BASE, ND_BONUS, ND_CPOS, ND_MMIDX, ND_MPOS,
                             ND_RPOS)
    g._encap_edges(16 * (qlen + 4) + 1024)
    nd = g._nd
    out = np.zeros(10, np.int64)
    _check(rowops_lib().bsa_alignment2graph(
        *gfull_args(g),
        nd[ND_MPOS].ctypes.data, nd[ND_RPOS].ctypes.data,
        nd[ND_MMIDX].ctypes.data, nd[ND_BASE].ctypes.data,
        nd[ND_BONUS].ctypes.data, nd[ND_CPOS].ctypes.data,
        states_map.ctypes.data, ndoffs_arr.ctypes.data,
        arena.ptrs[0], arena.ptrs[1], arena.ptrs[2], arena.ptrs[3],
        qprof_ptrs[0], qprof_ptrs[1], qprof_ptrs[2], qprof_ptrs[3],
        W, bandwidth, qlen, qb, piecewise, parO, parE, parQ, parP,
        is_overlap, nhead, ntail, midx, xe, rid, rbeg,
        out.ctypes.data), "alignment2graph")
    return _stats_rs(out, rs)


def align_rd_full(g, rdseq, cns, par, nseq, rid, rbeg, rend, realn):
    """Whole-read POA alignment in one call (sel_nodes + band placement +
    row DP + alignment2graph + bridge reverts); returns the filled
    AlnResult. The caller must pre-screen configs the C path does not
    cover (refmode CIGAR placement, ksz==0 band trigger)."""
    from ..poa.graph import (ND_BASE, ND_BLESS, ND_BONUS, ND_CPOS, ND_MMIDX,
                             ND_MPOS, ND_NCT, ND_RPOS, ND_VST)
    rlen = rend - rbeg
    g._encap_edges(4 * len(g.nodes) + 24 * (rlen + 4) + 2048)
    nd = g._nd
    ndoffs = np.asarray(g.ndoffs, np.int64)
    rs_out = np.zeros(10, np.int64)
    qc = np.ascontiguousarray(rdseq, np.uint8)
    tc = np.ascontiguousarray(cns, np.uint8)
    _check(rowops_lib().bsa_align_rd_full(
        *gfull_args(g),
        nd[ND_MPOS].ctypes.data, nd[ND_VST].ctypes.data,
        nd[ND_NCT].ctypes.data, nd[ND_MMIDX].ctypes.data,
        nd[ND_BASE].ctypes.data, nd[ND_BONUS].ctypes.data,
        nd[ND_BLESS].ctypes.data, nd[ND_RPOS].ctypes.data,
        nd[ND_CPOS].ctypes.data, ndoffs.ctypes.data, len(g.nodes),
        g.HEAD, g.TAIL, qc.ctypes.data, tc.ctypes.data, len(tc),
        par.alnmode, par.bandwidth, int(par.bwtrigger), par.ksz, par.nrec,
        par.M, par.X, par.refbonus, par.O, par.E, par.Q, par.P, par.T,
        nseq, rid, rbeg, rend, int(realn), rs_out.ctypes.data),
        "align_rd_full")
    return _stats_rs(rs_out, AlnResult())


def end_begin_loop(g, seqcat, seqoffs, rdlens, ndoffs_arr, par, nmsa, nall,
                   rid_start, msacols_buf, mrow, cns_buf, stack_buf, out):
    """Incremental end_bspoa loop (msa + simple_cns + align per read);
    returns the next unprocessed rid (== nmsa when done). See
    bsa_end_begin_loop in rowops.cpp for the out[]/resume contract."""
    from ..poa.graph import (ND_BASE, ND_BLESS, ND_BONUS, ND_CPOS, ND_INUSE,
                             ND_MMIDX, ND_MPOS, ND_NCT, ND_RPOS, ND_VST)
    nd = g._nd
    return _check(rowops_lib().bsa_end_begin_loop(
        *gfull_args(g),
        nd[ND_MPOS].ctypes.data, nd[ND_VST].ctypes.data,
        nd[ND_NCT].ctypes.data, nd[ND_INUSE].ctypes.data,
        nd[ND_MMIDX].ctypes.data, nd[ND_BASE].ctypes.data,
        nd[ND_BONUS].ctypes.data, nd[ND_BLESS].ctypes.data,
        nd[ND_RPOS].ctypes.data, nd[ND_CPOS].ctypes.data,
        ndoffs_arr.ctypes.data, rdlens.ctypes.data,
        seqcat.ctypes.data, seqoffs.ctypes.data,
        len(g.nodes), g.HEAD, g.TAIL,
        par.alnmode, par.bandwidth, int(par.bwtrigger), par.ksz, par.nrec,
        par.M, par.X, par.refbonus, par.O, par.E, par.Q, par.P, par.T,
        nmsa, nall, rid_start,
        msacols_buf.ctypes.data, mrow, len(msacols_buf),
        cns_buf.ctypes.data, len(cns_buf),
        stack_buf.ctypes.data, len(stack_buf), out.ctypes.data),
        "end_begin loop")


# -------------------------------------------------- MSA and consensus
def sort_nodes(g):
    """Topological column assignment; returns mlen."""
    from ..poa.graph import (ED_NEXT, ED_NODE, ND_EDGE, ND_EREV, ND_INUSE,
                             ND_MPOS, ND_NCT, ND_NEXT, ND_NIN, ND_NOU,
                             ND_VST)
    nd = g._nd
    ed = g._ed
    n = len(g.nodes)
    stack = np.zeros(n + 8, np.int32)
    r = rowops_lib().bsa_sort_nodes(
        nd[ND_MPOS].ctypes.data, nd[ND_VST].ctypes.data,
        nd[ND_NCT].ctypes.data, nd[ND_INUSE].ctypes.data,
        nd[ND_NIN].ctypes.data, nd[ND_NOU].ctypes.data,
        nd[ND_NEXT].ctypes.data, nd[ND_EDGE].ctypes.data,
        nd[ND_EREV].ctypes.data, ed[ED_NODE].ctypes.data,
        ed[ED_NEXT].ctypes.data, n, g.HEAD, g.TAIL,
        stack.ctypes.data, len(stack))
    msg = {-1: "sort_nodes overflow", -2: "sort_nodes did not reach HEAD",
           -4: "tail chain fork"}
    if r in msg:
        raise RuntimeError(msg[r])
    return _check(r, "sort_nodes")


def msa_fill(g, msacols, msaidxs_arr, mlen, mrow):
    from ..poa.graph import (ED_NEXT, ED_NODE, ND_BASE, ND_EDGE, ND_EREV,
                             ND_MPOS, ND_NCT, ND_NEXT, ND_NIN, ND_RID,
                             ND_VST)
    nd = g._nd
    ed = g._ed
    n = len(g.nodes)
    stack = np.zeros(n + 8, np.int32)
    r = rowops_lib().bsa_msa_fill(
        nd[ND_MPOS].ctypes.data, nd[ND_VST].ctypes.data,
        nd[ND_NCT].ctypes.data, nd[ND_NIN].ctypes.data,
        nd[ND_NEXT].ctypes.data, nd[ND_EDGE].ctypes.data,
        nd[ND_EREV].ctypes.data, nd[ND_RID].ctypes.data,
        nd[ND_BASE].ctypes.data, ed[ED_NODE].ctypes.data,
        ed[ED_NEXT].ctypes.data, n, g.HEAD, g.TAIL,
        msacols.ctypes.data, msaidxs_arr.ctypes.data, mlen, mrow,
        stack.ctypes.data, len(stack))
    msg = {-1: "msa fill overflow", -2: "msa fill did not reach TAIL"}
    if r in msg:
        raise RuntimeError(msg[r])
    _check(r, "msa fill")


def mask_lead_tail(msacols, msaidxs_arr, mlen, mrow, nseq):
    rowops_lib().bsa_mask_lead_tail(msacols.ctypes.data,
                                    msaidxs_arr.ctypes.data, mlen, mrow,
                                    nseq)


def simple_cns(msacols, msaidxs_arr, mlen, mrow, nseq, nall, cpos_arr,
               ndoffs_arr):
    """Majority-vote consensus; returns per-column bsel [mlen] (filter <4
    for the cns string). Mutates msacols + node cpos in place."""
    bsel = np.empty(mlen, np.uint8)
    rowops_lib().bsa_simple_cns(
        msacols.ctypes.data, msaidxs_arr.ctypes.data, mlen, mrow, nseq,
        nall, cpos_arr.ctypes.data, ndoffs_arr.ctypes.data,
        bsel.ctypes.data)
    return bsel


def cns_forward(colmat, nseq, dptable, dpvals, min_freq):
    """HMM-consensus forward scan; returns (sc, btm, lbm)."""
    lib = rowops_lib()
    mlen, mrow = colmat.shape
    sc = np.zeros((5, mlen + 1, 6), np.float64)
    btm = np.zeros((5, mlen + 1), np.uint8)
    lbm = np.zeros((5, mlen + 1), np.uint8)
    lib.bsa_cns_forward(colmat.ctypes.data, mlen, mrow, nseq,
                        dptable.ctypes.data, dpvals.ctypes.data,
                        float(min_freq), sc.ctypes.data, btm.ctypes.data,
                        lbm.ctypes.data)
    return sc, btm, lbm


def cns_tail(sc, btm, msacols, msaidxs, mlen, nall, nmax, psub, qlt_max):
    """Consensus backtrace + QLT/ALT tail. Mutates msacols rows (cns/qlt/alt
    columns); returns (cns, qlt, alt, ret)."""
    lib = rowops_lib()
    cns = np.zeros(mlen, np.uint8)
    qlt = np.zeros(mlen, np.uint8)
    alt = np.zeros(mlen, np.uint8)
    ret = np.zeros(1, np.float64)
    n = lib.bsa_cns_tail(sc.ctypes.data, btm.ctypes.data,
                         msacols.ctypes.data, msacols.shape[1],
                         msaidxs.ctypes.data, mlen, nall, nmax,
                         float(psub), qlt_max, cns.ctypes.data,
                         qlt.ctypes.data, alt.ctypes.data, ret.ctypes.data)
    return cns[:n].copy(), qlt[:n].copy(), alt[:n].copy(), float(ret[0])


def msanode_cns_merges(g, msacols, msaidxs_arr, mlen, mrow, nall, nseq,
                       ndoffs_arr, cnsnode0):
    from ..poa.graph import ND_MPOS
    g._encap_edges(16 * mlen + 1024)
    return _check(rowops_lib().bsa_msanode_cns_merges(
        *gfull_args(g), g._nd[ND_MPOS].ctypes.data, msacols.ctypes.data,
        msaidxs_arr.ctypes.data, mlen, mrow, nall, nseq,
        ndoffs_arr.ctypes.data, cnsnode0), "cns merges")


def msanode_rail_merges(g, msacols, msaidxs_arr, mlen, mrow, nall, nseq,
                        ndoffs_arr):
    from ..poa.graph import ND_BASE
    g._encap_edges(32 * mlen + 4096)
    _check(rowops_lib().bsa_msanode_rail_merges(
        *gfull_args(g), g._nd[ND_BASE].ctypes.data, msacols.ctypes.data,
        msaidxs_arr.ctypes.data, mlen, mrow, nall, nseq,
        ndoffs_arr.ctypes.data), "rail merges")


# ------------------------------------------------ profile realignment
def hp_adjust(mlen, cnsrow, cnt, cap255):
    """Homopolymer count re-attribution over a [mlen,4] int64 count matrix
    (in place); cnsrow is the uint8 consensus row."""
    rowops_lib().bsa_hp_adjust(mlen, cnsrow.ctypes.data, cnt.ctypes.data,
                               1 if cap255 else 0)


def pedit_forward(matrix0, matrix1, seqs0, seqs1, mats0, mats1, mlen, mbeg,
                  mend, bw, HW, rowlen) -> None:
    """Anti-diagonal forward pass of the remsa pedit DP on the host (fills
    the matrix diagonals in place): the reference that ops/pedit.py's plain
    version and CUDA kernel are held against."""
    rowops_lib().bsa_pedit_forward(
        matrix0.ctypes.data, matrix1.ctypes.data, seqs0.ctypes.data,
        seqs1.ctypes.data, mats0.ctypes.data, mats1.ctypes.data, mlen, mbeg,
        mend, bw, HW, rowlen, mats0.shape[1])


def pedit_traceback(g, matrix0, matrix1, seqs0, seqs1, mats0, mats1,
                    ndoffs_arr, mlen, mbeg, mend, HW, rowlen, rid,
                    nseq_plus1, qe):
    """Pedit traceback; replays safely on edge-capacity growth (the path
    depends only on the matrices, and re-merging is a no-op)."""
    lib = rowops_lib()
    while True:
        g._encap_edges(4096)
        g._estate[3] = 0
        r = lib.bsa_pedit_traceback(
            *gfull_args(g), matrix0.ctypes.data, matrix1.ctypes.data,
            seqs0.ctypes.data, seqs1.ctypes.data, mats0.ctypes.data,
            mats1.ctypes.data, ndoffs_arr.ctypes.data, mlen, mbeg, mend,
            HW, rowlen, mats0.shape[1], rid, nseq_plus1, qe)
        if r == -2 and g._estate[3] == 1:
            g._encap_edges(len(g._ed[0]))       # grow and replay
            continue
        return _check(r, "pedit traceback")


# ------------------------------------------------------ edit oracles
def _edit_rs(out):
    rs = AlnResult()
    (rs.qb, rs.qe, rs.tb, rs.te, rs.mat, rs.mis, rs.ins, rs.dele, rs.aln,
     rs.score) = (int(v) for v in out)
    return rs


def edit_align(qseq, tseq, modetype, bandwidth):
    """Scalar edit_pairwise (forward + backtrace + mode scoring); returns
    (AlnResult, cigars list)."""
    qc = np.ascontiguousarray(qseq, np.uint8)
    tc = np.ascontiguousarray(tseq, np.uint8)
    cap = len(qc) + len(tc) + 16
    cg = np.empty(cap, np.uint32)
    out = np.zeros(10, np.int64)
    n = rowops_lib().bsa_edit_align(qc.ctypes.data, len(qc), tc.ctypes.data,
                                    len(tc), modetype, bandwidth,
                                    cg.ctypes.data, cap, out.ctypes.data)
    if n < 0:
        raise RuntimeError("native edit_align cigar overflow")
    return _edit_rs(out), cg[:n].tolist()


def kmer_edit(ksz, qseq, tseq):
    """Scalar kmer_edit_pairwise; returns (AlnResult, cigars list)."""
    qc = np.ascontiguousarray(qseq, np.uint8)
    tc = np.ascontiguousarray(tseq, np.uint8)
    cap = len(qc) + len(tc) + 16
    cg = np.empty(cap, np.uint32)
    out = np.zeros(10, np.int64)
    n = rowops_lib().bsa_kmer_edit(qc.ctypes.data, len(qc), tc.ctypes.data,
                                   len(tc), ksz, cg.ctypes.data, cap,
                                   out.ctypes.data)
    if n < 0:
        raise RuntimeError("native kmer_edit cigar overflow")
    return _edit_rs(out), cg[:n].tolist()
