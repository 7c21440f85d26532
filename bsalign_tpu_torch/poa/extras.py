"""BSPOA debug dumps (port of the part of bsalign_tpu.poa.extras that the
`poa` CLI's -T reaches)."""
from __future__ import annotations

from .core import BSPOA

MAX_POS = 0x7FFFFFFF


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
