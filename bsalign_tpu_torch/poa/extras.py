"""BSPOA library extras: subset/clip, MSA merge, LSP re-POA, debug dumps
(port of bsalign_tpu.poa.extras).

Equivalents of the reference's auxiliary BSPOA surface:
- subset_bspoa (bspoa.h:5745-5801): row-subset a finished MSA into a new
  BSPOA and re-call consensus.
- calc_msa/cns_rdregs + clip_reads_msa (bspoa.h:5803-5886): per-read MSA
  spans and head/tail clipping (clipped cells become code 5).
- add/del_cnsnodes (bspoa.h:2980-3048): insert the consensus as read
  rid==nseq whose nodes join matching read rings.
- gen_lsps/remsa_lsps (bspoa.h:5300-5565): find low-scoring windows per
  read against the consensus and re-POA each window in place (the CLI
  leaves this off, main.c:526, but it is part of the library surface).
- beg/push/end_merge (bspoa.h:5636-5739): merge multiple finished MSAs
  into one POA by aligning their consensuses (reference marks this
  TODO/debug; behavior reproduced with the display-order indexing fixed).
- Graphviz DOT dumps + FASTA debug dump (bspoa.h:1162-1318).

A BSPOA carries its device: `subset` keeps the source's, `merge_msas`
takes one, and the realignment rounds of `BSPOA.end` inside them run the
pedit kernel there (its plain version on the CPU).
"""
from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np

from .core import BSPOA, BSPOAPar

HSP_MINLEN = 3
CUTEDGE, CUTNODE, CUTALL = 1, 2, 3
MAX_POS = 0x7FFFFFFF


# ------------------------------------------------------------- subset/clip
def subset(g: BSPOA, keep: Sequence[int]) -> BSPOA:
    """Build a new BSPOA containing only reads with keep[rid] true; read 0
    is always kept (subset_bspoa forces bit 0). Columns are copied in
    display order and consensus re-called."""
    assert g.nrds == len(g.seqs), "subset requires a finished, unshuffled MSA"
    keep = list(keep) + [False] * (len(g.seqs) - len(keep))
    keep[0] = True
    d = BSPOA(copy.deepcopy(g.par), device=g.device)
    d.par.refmode = 1
    d.beg()
    sel = [rid for rid in range(len(g.seqs)) if keep[rid]]
    for rid in sel:
        d.push_codes(g.seqs[rid].copy())
    d.nrds = d.nmsa = len(sel)
    mlen = len(g.msaidxs)
    nall = len(g.seqs)
    mrow_d = d.nrds + 3
    d.msaidxs = list(range(mlen))
    d.msacols = np.zeros((mlen, mrow_d), np.uint8)
    order = np.asarray(g.msaidxs, np.int64)
    src = np.asarray(g.msacols)[order]
    d.msacols[:, :d.nrds] = src[:, np.asarray(sel, np.int64)]
    d.cns_call()
    return d


def calc_msa_rdregs(g: BSPOA):
    """Per-read first/last non-gap MSA column (bspoa.h:5803-5826)."""
    nseq = g.nrds
    mlen = len(g.msaidxs)
    rbegs, rends = [0] * nseq, [0] * nseq
    for i in range(nseq):
        if g.rdlen(i) == 0:
            continue
        for pos in range(mlen):
            if g.msacols[g.msaidxs[pos]][i] < 4:
                break
        rbegs[i] = pos
        for pos in range(mlen, 0, -1):
            if g.msacols[g.msaidxs[pos - 1]][i] < 4:
                break
        rends[i] = pos
    return rbegs, rends


def calc_cns_rdregs(g: BSPOA):
    """Per-read span in consensus coordinates (bspoa.h:5829-5855)."""
    nseq = g.nrds
    nall = nseq if g.nseq == 0 else g.nseq
    mlen = len(g.msaidxs)
    rbegs, rends = [0] * nseq, [0] * nseq
    for i in range(nseq):
        if g.rdlen(i) == 0:
            continue
        j = 0
        for pos in range(mlen):
            col = g.msacols[g.msaidxs[pos]]
            if col[i] < 4:
                break
            if col[nall] < 4:
                j += 1
        rbegs[i] = j
        j = 0
        for pos in range(mlen, 0, -1):
            col = g.msacols[g.msaidxs[pos - 1]]
            if col[i] < 4:
                break
            if col[nall] < 4:
                j += 1
        rends[i] = len(g.cns) - j
    return rbegs, rends


def clip_reads_msa(g: BSPOA, clip_head: int, clip_tail: int) -> None:
    """Mask each read's first clip_head / last clip_tail bases in the MSA
    (cells set to 5; bspoa.h:5858-5886)."""
    if clip_head + clip_tail == 0:
        return
    nseq = g.nrds
    roffs = [0] * nseq
    rbegs = [clip_head] * nseq
    rends = [max(g.rdlen(i), clip_tail) - clip_tail for i in range(nseq)]
    for pos in range(len(g.msaidxs)):
        col = g.msacols[g.msaidxs[pos]]
        for i in range(nseq):
            if col[i] < 4:
                roffs[i] += 1
            if roffs[i] <= rbegs[i] or roffs[i] > rends[i]:
                col[i] = 5


# ------------------------------------------------------------ cns-as-read
def del_cnsnodes(g: BSPOA) -> None:
    """Remove the consensus-read nodes (del_cnsnodes_bspoa, bspoa.h:2980)."""
    gr = g.g
    nseq = len(g.seqs)
    if len(gr.ndoffs) <= nseq:
        return
    clen = len(gr.nodes) - gr.ndoffs[nseq] - 1
    for i in range(-1, clen + 1):
        gr.cut_rdnode(nseq, i, CUTALL)
    del gr.nodes[gr.ndoffs[nseq] - 1:]
    del gr.ndoffs[nseq:]
    del g.rdregs0[nseq:]
    del g.rdregs1[nseq:]


def add_cnsnodes(g: BSPOA) -> List[int]:
    """Insert the consensus as read rid==nseq; each cns node joins the ring
    of a matching read base in its column (add_cnsnodes_bspoa,
    bspoa.h:2997-3048). Returns per-read final MSA offsets."""
    del_cnsnodes(g)
    gr = g.g
    nseq = len(g.seqs)
    mlen = len(g.msaidxs)
    rps = [0] * nseq
    clen = 0
    u = gr.new_node(nseq, -1, 4)
    gr.merge_nodes(u, gr.HEAD)
    gr.ndoffs.append(len(gr.nodes))
    for pos in range(mlen):
        col = g.msacols[g.msaidxs[pos]]
        if col[nseq] < 4:
            u = gr.new_node(nseq, clen, int(col[nseq]))
            clen += 1
            for rid in range(nseq):
                if col[rid] == col[nseq]:
                    gr.merge_nodes(u, gr.rdnode(rid, rps[rid]))
                    gr.nodes[u].mpos = pos
                    break
            else:
                raise RuntimeError("cns base matches no read in its column")
        for rid in range(nseq):
            if col[rid] < 4:
                rps[rid] += 1
    u = gr.new_node(nseq, clen, 4)
    gr.merge_nodes(u, gr.TAIL)
    for i in range(clen + 1):
        gr.connect_rdnode(nseq, i)
    g.rdregs0.append(0)
    g.rdregs1.append(clen)
    return rps


# --------------------------------------------------------------- LSP re-POA
class Lsp:
    __slots__ = ("rid", "scr", "rbeg", "rlen", "mbeg", "mlen")

    def __init__(self, rid, scr, rbeg, rlen, mbeg, mlen):
        self.rid, self.scr = rid, scr
        self.rbeg, self.rlen = rbeg, rlen
        self.mbeg, self.mlen = mbeg, mlen


def _cal_rd_lsp_score(g: BSPOA, lsp: Lsp) -> float:
    """bspoa.h:5279-5298: event-table log-prob of a read window."""
    nseq = g.nrds
    nall = nseq if g.nseq == 0 else g.nseq
    c, d = 4, 0
    scr = 0.0
    for p in range(lsp.mlen):
        col = g.msacols[g.msaidxs[p + lsp.mbeg]]
        a = int(col[nall])
        b = int(col[lsp.rid])
        if b > 4:
            continue
        if a >= 4 and b >= 4:
            continue
        f = int(g.dptable[a + b * 5 + c * 25 + d * 125])
        scr += g.dpvals[f >> 3]
        d = f & 0x7
        if col[nall] < 4:
            c = int(col[nall])
    return -scr


def gen_lsps(g: BSPOA, par: BSPOAPar) -> List[Lsp]:
    """Cluster per-read low-scoring windows against the consensus
    (gen_lsps_bspoa, bspoa.h:5300-5462). A window opens at a low-quality or
    high-alt column (or read/cns disagreement), and closes after `wsz`
    consecutive agreeing non-homopolymer columns."""
    wsz = 5
    gr = g.g
    out: List[Lsp] = []
    if len(g.msaidxs) < wsz:
        return out
    nseq = g.nrds
    nall = nseq if g.nseq == 0 else g.nseq
    roffs = [0] * nseq
    hsps = [[0] * nseq for _ in range(8)]
    states = [1] * nseq
    lc = 4
    for pos in range(len(g.msaidxs)):
        col = g.msacols[g.msaidxs[pos]]
        q = int(col[nall + 1])
        a = int(col[nall + 2])
        c = min(int(col[nall]), 4)
        lsp_col = q < par.qlthi or a > par.althi
        if lsp_col:
            cnts = [0] * 6
            for rid in range(nseq):
                cnts[col[rid]] += 1
            for rid in range(nseq):
                if col[rid] == c:
                    if hsps[6][rid] == 0:
                        hsps[6][rid] = 1
                elif hsps[6][rid] > 1:
                    hsps[6][rid] += cnts[col[rid]]
                else:
                    hsps[6][rid] = 1 + cnts[col[rid]]
        for rid in range(nseq):
            b = min(int(col[rid]), 4)
            if b == 4 and c == 4:
                continue
            if lsp_col or b != c:
                if not lsp_col:
                    x = 0
                    v = gr.rdnode(rid, roffs[rid])
                    if b < 4:
                        if gr.get_nodecov(v) > 1:
                            if c < 4:
                                x = 1
                            else:
                                w = gr.nodes[gr.rdnode(rid, roffs[rid] - 1)]
                                w2 = gr.nodes[gr.rdnode(rid, roffs[rid] + 1)]
                                if w.base != b and w2.base != b:
                                    x = 1
                    else:
                        w = gr.rdnode(rid, roffs[rid] - 1)
                        e = gr.get_edge(w, v)
                        if e and gr.edges[e].cov > 1:
                            x = 1
                    if x == 1:
                        hsps[5][rid] += 1
                        hsps[4][rid] = 0
                if lsp_col or (b != c and b != 4 and c != 4):
                    if b != c and b != 4 and c != 4 and hsps[6][rid] == 0:
                        hsps[6][rid] = 1
                    hsps[4][rid] = 0
                    if states[rid] == 1:
                        hsps[0][rid] = hsps[2][rid]
                        hsps[1][rid] = hsps[3][rid]
                    states[rid] = 0
                hsps[7][rid] = 1
            else:
                if states[rid] == 0:
                    states[rid] = 2
                if c != lc:
                    hsps[4][rid] += 1
                    if states[rid] == 2 and hsps[4][rid] >= 2 \
                            and hsps[7][rid] == 0:
                        hsps[2][rid] = roffs[rid]
                        hsps[3][rid] = pos
                        hsps[5][rid] = 0
                        states[rid] = 3
                    if states[rid] == 3 and hsps[4][rid] >= wsz:
                        states[rid] = 1
                        if hsps[0][rid] and hsps[6][rid]:
                            lsp = Lsp(rid, 0.0, hsps[0][rid],
                                      hsps[2][rid] - hsps[0][rid],
                                      hsps[1][rid],
                                      hsps[3][rid] - hsps[1][rid])
                            lsp.scr = (hsps[6][rid] * 100 + hsps[5][rid]
                                       + _cal_rd_lsp_score(g, lsp))
                            out.append(lsp)
                    if states[rid] == 1:
                        if hsps[4][rid] >= wsz and hsps[7][rid] == 0:
                            hsps[2][rid] = roffs[rid]
                            hsps[3][rid] = pos
                        hsps[5][rid] = 0
                        hsps[6][rid] = 0
                hsps[7][rid] = 0
            if b < 4:
                roffs[rid] += 1
        if c < 4:
            lc = c
    return out


def remsa_lsps(g: BSPOA, par: BSPOAPar) -> int:
    """Re-POA each low-scoring window in place (remsa_lsps_bspoa,
    bspoa.h:5463-5565): pin the consensus as blessed nodes, cut each LSP
    window out of the graph, realign it windowed, then rebuild MSA+cns."""
    gr = g.g
    for v in gr.nodes:
        v.colorful = 0
    add_cnsnodes(g)
    nseq = g.nrds
    for i in range(len(g.cns)):
        gr.nodes[gr.rdnode(nseq, i)].bless = 1
    lsps = gen_lsps(g, par)
    lsps.sort(key=lambda l: l.scr)
    for lsp in lsps:
        for pos in range(lsp.rbeg, lsp.rbeg + lsp.rlen):
            vi = gr.cut_rdnode(lsp.rid, pos, CUTEDGE)
            gr.nodes[vi].bless = 0
            gr.nodes[vi].colorful = 1
    for lsp in lsps:
        for pos in range(lsp.rbeg, lsp.rbeg + lsp.rlen):
            gr.cut_rdnode(lsp.rid, pos, CUTNODE)
        g.align_rd(par, 1, lsp.rid, lsp.rbeg, lsp.rlen)
    del_cnsnodes(g)
    g.msa()
    g.cns_call()
    return len(lsps)


# ----------------------------------------------------------------- DOT dumps
def print_dot(g: BSPOA, out, posbeg: int = 0, posend: int = MAX_POS,
              mincnt: int = 0) -> None:
    """Graphviz dump of the POA graph (print_dot_bspoa, bspoa.h:1162):
    ring headers as nodes 'N<idx> rid:pos:base', edges weighted by cov."""
    gr = g.g
    out.write("digraph bspoa {\n")
    out.write("  rankdir=LR; node [shape=record];\n")
    for idx, v in enumerate(gr.nodes):
        if v.header != idx:
            continue
        if not (posbeg <= v.mpos < posend):
            continue
        out.write('  N%d [label="{%d:%d|%s|cov=%d}"];\n' % (
            idx, v.rid, v.pos, "ACGTN-"[min(v.base, 5)], gr.get_nodecov(idx)))
    for idx, v in enumerate(gr.nodes):
        if v.header != idx or not (posbeg <= v.mpos < posend):
            continue
        for eidx, e in gr.iter_edges(idx, False):
            w = gr.nodes[e.node]
            if e.cov < mincnt or not (posbeg <= w.mpos < posend):
                continue
            out.write('  N%d -> N%d [label="%d"%s];\n' % (
                idx, e.node, e.cov,
                " color=red" if e.cov <= 1 else ""))
    out.write("}\n")


def print_vstdot(g: BSPOA, out) -> None:
    """Like print_dot but labels carry visit state (print_vstdot_bspoa)."""
    gr = g.g
    out.write("digraph bspoa_vst {\n")
    for idx, v in enumerate(gr.nodes):
        if v.header != idx:
            continue
        out.write('  N%d [label="%d:%d:%s vst=%d/%d"];\n' % (
            idx, v.rid, v.pos, "ACGTN-"[min(v.base, 5)], v.vst, v.nct))
        for eidx, e in gr.iter_edges(idx, False):
            out.write("  N%d -> N%d;\n" % (idx, e.node))
    out.write("}\n")


def print_local_dot(g: BSPOA, out, nidx: int, step: int = 5) -> None:
    """BFS neighborhood dump around one node (print_local_dot_bspoa)."""
    gr = g.g
    seen = {nidx: 0}
    frontier = [nidx]
    while frontier:
        u = frontier.pop(0)
        if seen[u] >= step:
            continue
        for rev in (False, True):
            for eidx, e in gr.iter_edges(gr.nodes[u].header, rev):
                if e.node not in seen:
                    seen[e.node] = seen[u] + 1
                    frontier.append(e.node)
    out.write("digraph bspoa_local {\n")
    for idx in sorted(seen):
        v = gr.nodes[idx]
        out.write('  N%d [label="%d:%d:%s"];\n' % (
            idx, v.rid, v.pos, "ACGTN-"[min(v.base, 5)]))
        for eidx, e in gr.iter_edges(gr.nodes[idx].header, False):
            if e.node in seen:
                out.write("  N%d -> N%d;\n" % (idx, e.node))
    out.write("}\n")


def print_seqs(g: BSPOA, out) -> None:
    """FASTA dump of all reads (print_seqs_bspoa, bspoa.h:1318)."""
    for rid in range(len(g.seqs)):
        out.write(">S%d len=%d\n" % (rid, g.rdlen(rid)))
        out.write("".join("ACGT"[b] for b in g.seqs[rid]) + "\n")


# ------------------------------------------------------------------- merge
def merge_msas(par: BSPOAPar, msas: List[tuple], *, device) -> BSPOA:
    """Merge several finished MSAs into one BSPOA (beg/push/end_merge,
    bspoa.h:5636-5739, which the reference marks TODO/debug).

    msas: list of (msacols_matrix [mlen, nseq+1+], nseq) in display order —
    rows 0..nseq-1 are reads, row nseq the consensus. Their consensuses are
    POA-aligned; matching consensus columns splice the member graphs'
    aligned rings together; then realignment rounds polish the union.
    Both POAs run on `device`.
    """
    dg = BSPOA(copy.deepcopy(par), device=device)
    mg = BSPOA(copy.deepcopy(par), device=device)
    dg.beg()
    mg.beg()
    sels = {}            # (msa_idx, cns_pos) -> dg node idx
    nread_off = []
    for mi, (mat, nseq) in enumerate(msas):
        mlen = mat.shape[0]
        nread_off.append(len(dg.seqs))
        # push member reads into dg, consensus into mg
        for ridx in range(nseq + 1):
            seq = mat[:, ridx]
            seq = seq[seq < 4]
            if ridx == nseq:
                mg.push_codes(np.asarray(seq, np.uint8))
            else:
                dg.push_codes(np.asarray(seq, np.uint8))
    # materialize dg node chains
    for rid in range(len(dg.seqs)):
        dg._add_read_core(rid)
    roff = 0
    for mi, (mat, nseq) in enumerate(msas):
        mlen = mat.shape[0]
        rpos = [0] * nseq
        cpos = 0
        for mpos in range(mlen):
            col = mat[mpos]
            nidxs = [0, 0, 0, 0]
            for ridx in range(nseq):
                b = int(col[ridx])
                if b >= 4:
                    continue
                nidx = dg.g.rdnode(roff + ridx, rpos[ridx])
                if nidxs[b]:
                    dg.g.merge_nodes(nidxs[b], nidx)
                else:
                    nidxs[b] = nidx
                rpos[ridx] += 1
            cb = int(col[nseq])
            if cb < 4:
                sels[(mi, cpos)] = nidxs[cb] if nidxs[cb] else 0
                cpos += 1
        for ridx in range(nseq):
            for i in range(len(dg.seqs[roff + ridx]) + 1):
                dg.g.connect_rdnode(roff + ridx, i)
        roff += nseq
    # align member consensuses against each other
    mg.end()
    mlen = len(mg.msaidxs)
    nmg = mg.nrds
    rpos = [0] * nmg
    for mpos in range(mlen):
        col = mg.msacols[mg.msaidxs[mpos]]
        nidxs = [0, 0, 0, 0]
        for ridx in range(nmg):
            b = int(col[ridx])
            if b >= 4:
                continue
            nidx = sels.get((ridx, rpos[ridx]), 0)
            if nidx:
                if nidxs[b]:
                    dg.g.merge_nodes(nidxs[b], nidx)
                else:
                    nidxs[b] = nidx
            rpos[ridx] += 1
    dg.nrds = len(dg.seqs)
    dg.nmsa = dg.nrds
    try:
        dg.msa()
        for _ in range(max(1, par.realn)):
            dg.cns_call()
            dg.remsa_edits(par.editbw)
            dg.msa()
        dg.cns_call()
        return dg
    except RuntimeError:
        # The column-splice can produce an unsortable (cyclic) graph — the
        # reference's merge has the same flaw (marked TODO, bspoa.h:5634).
        # Fall back to a full re-POA of the union of member reads.
        return _full_repoa(par, msas, device)


def _full_repoa(par: BSPOAPar, msas: List[tuple], device) -> BSPOA:
    dg = BSPOA(copy.deepcopy(par), device=device)
    dg.beg()
    for mat, nseq in msas:
        for ridx in range(nseq):
            seq = mat[:, ridx]
            seq = seq[seq < 4]
            if len(seq):
                dg.push_codes(np.asarray(seq, np.uint8))
    dg.end()
    return dg
