"""POA graph data model: nodes, paired edges, aligned-node rings (port of
bsalign_tpu.poa.graph).

Mirrors the reference's semantics (bspoa.h:28-101, 394-902): nodes carry a
circular "aligned ring" (next/prev/header); edges come in fwd/rev pairs at
even/odd indices with per-node linked lists kept sorted by coverage
descending (insertion after equals — iteration order is a tie-break input to
alignment, so it must match exactly).

Storage is struct-of-arrays: every node and edge field lives in a NumPy
int32 array, and the mutators (chg_edge, cut_rdnode, merge_nodes and the
range cuts and connects of native/rowops.py) run in the host C++ over those
arrays with one call each. `Node` and `EdgeRef` are views over the arrays.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..native import rowops as NR

_NODE_GROW = 1024
_EDGE_GROW = 4096


def _grow(a: np.ndarray, cap: int) -> np.ndarray:
    """Reallocate to cap entries (contents past the old length are
    uninitialized — callers init new slots)."""
    b = np.empty(cap, a.dtype)
    b[:len(a)] = a
    return b


(ND_RID, ND_COV, ND_RDC, ND_RDD, ND_NIN, ND_NOU, ND_EDGE, ND_EREV,
 ND_NEXT, ND_PREV, ND_HEADER, ND_BASE, ND_MPOS, ND_VST, ND_NCT, ND_INUSE,
 ND_BONUS, ND_RPOS, ND_MMIDX, ND_CPOS, ND_BLESS, ND_POS, ND_REF, ND_AUX,
 ND_COLOR) = range(25)
_ND_FIELDS = ("rid", "cov", "rdc", "rdd", "nin", "nou", "edge", "erev",
              "next", "prev", "header", "base", "mpos", "vst", "nct",
              "inuse", "bonus", "rpos", "mmidx", "cpos", "bless", "pos",
              "ref", "aux", "colorful")
# fields a new node starts with at 0
_ND_ZERO = (ND_RDC, ND_RDD, ND_NIN, ND_NOU, ND_EDGE, ND_EREV, ND_INUSE,
            ND_BONUS, ND_VST, ND_NCT, ND_MPOS, ND_RPOS, ND_MMIDX, ND_CPOS,
            ND_BLESS, ND_REF, ND_AUX, ND_COLOR)

(ED_NODE, ED_COV, ED_VST, ED_NEXT) = range(4)


class Node:
    """View of one node over the graph's SoA arrays: `g.nodes[i]`
    materializes a 2-slot view on demand."""

    __slots__ = ("g", "idx")


def _mk_prop(fi):
    def get(self):
        return int(self.g._nd[fi][self.idx])

    def set_(self, v):
        self.g._nd[fi][self.idx] = v
    return property(get, set_)


for _fi, _fn in enumerate(_ND_FIELDS):
    setattr(Node, _fn, _mk_prop(_fi))


class EdgeRef:
    """View of one edge slot (valid until the graph mutates)."""

    __slots__ = ("g", "idx")

    def __init__(self, g: "Graph", idx: int):
        self.g = g
        self.idx = idx

    @property
    def node(self) -> int:
        return int(self.g._ed[ED_NODE][self.idx])

    @property
    def cov(self) -> int:
        return int(self.g._ed[ED_COV][self.idx])


class _EdgesView:
    """Lazy list of EdgeRef views over the edge slots."""

    __slots__ = ("g",)

    def __init__(self, g: "Graph"):
        self.g = g

    def __getitem__(self, idx: int) -> EdgeRef:
        return EdgeRef(self.g, idx)

    def __len__(self) -> int:
        return self.g._elen


class _NodesView:
    """Lazy list of Node views: nothing is stored per node."""

    __slots__ = ("g", "_n")

    def __init__(self, g: "Graph"):
        self.g = g
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Node:
        v = Node.__new__(Node)
        v.g = self.g
        v.idx = idx + self._n if idx < 0 else idx
        return v

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def __delitem__(self, sl) -> None:
        # only tail truncation is used (del nodes[k:])
        if not (isinstance(sl, slice) and sl.stop is None and sl.step is None):
            raise TypeError("only `del nodes[k:]` is supported")
        start = sl.start
        if start < 0:
            start += self._n
        self._n = min(self._n, max(0, start))


class Graph:
    """Node/edge store with the reference's exact list disciplines."""

    def __init__(self):
        self.nodes = _NodesView(self)
        self.edges = _EdgesView(self)
        self._nd = [np.zeros(_NODE_GROW, np.int32) for _ in range(25)]
        self._ed = [np.zeros(_EDGE_GROW, np.int32) for _ in range(4)]
        # estate: [0]=edge count (idx 0/1 reserved), [1]=recycle-stack size,
        # [2]=edge capacity, [3]=error flag — shared with the C++
        self._estate = np.array([2, 0, _EDGE_GROW, 0], np.int64)
        self._ecyc = np.zeros(_EDGE_GROW // 2, np.int32)
        self.HEAD = 0
        self.TAIL = 1
        self.ndoffs: List[int] = []
        self._gargs = None                  # cached native pointer pack

    # --- storage ---
    def _encap_nodes_to(self, n: int) -> None:
        if n >= len(self._nd[0]):
            cap = max(n + 1, len(self._nd[0]) * 2)
            self._nd = [_grow(a, cap) for a in self._nd]
            self._gargs = None

    @property
    def _elen(self) -> int:
        return int(self._estate[0])

    def _encap_edges(self, extra: int) -> None:
        if self._elen + extra >= len(self._ed[0]):
            cap = max(self._elen + extra, len(self._ed[0]) * 2)
            self._ed = [_grow(a, cap) for a in self._ed]
            self._estate[2] = cap
            self._ecyc = _grow(self._ecyc, cap // 2)
            self._gargs = None

    # --- nodes ---
    def new_node(self, rid: int, pos: int, base: int) -> int:
        return self.new_nodes_bulk(rid, pos, np.array([base], np.int32))

    def new_nodes_bulk(self, rid: int, pos0: int, bases) -> int:
        """Append len(bases) nodes with consecutive positions; returns the
        first index."""
        n = len(bases)
        i0 = self.nodes._n
        self._encap_nodes_to(i0 + n + 1)
        nd = self._nd
        sl = slice(i0, i0 + n)
        for f in _ND_ZERO:
            nd[f][sl] = 0
        nd[ND_RID][sl] = rid
        nd[ND_COV][sl] = 1
        idxs = np.arange(i0, i0 + n, dtype=np.int32)
        nd[ND_NEXT][sl] = idxs
        nd[ND_PREV][sl] = idxs
        nd[ND_HEADER][sl] = idxs
        nd[ND_BASE][sl] = bases
        nd[ND_POS][sl] = pos0 + np.arange(n, dtype=np.int32)
        self.nodes._n = i0 + n
        return i0

    def rdnode(self, rid: int, pos: int) -> int:
        return self.ndoffs[rid] + pos

    def get_nodecov(self, u: int) -> int:
        nd = self._nd
        return int(nd[ND_COV][nd[ND_HEADER][u]])

    # --- edges and rings (host C++) ---
    def chg_edge(self, _u, _v, cov: int):
        """Returns (eidx_or_0, existed) (bspoa.h:561-606)."""
        if cov == 0 or _u is None or _v is None:
            return 0, 0
        self._encap_edges(4)
        return NR.g_chg_edge(self, _u, _v, cov)

    def get_edge(self, _u: int, _v: int) -> int:
        """The edge slot u -> v between the two rings' headers, else 0."""
        nd = self._nd
        ed = self._ed
        v = nd[ND_HEADER][_v]
        eidx = int(nd[ND_EDGE][nd[ND_HEADER][_u]])
        while eidx:
            if ed[ED_NODE][eidx] == v:
                return eidx
            eidx = int(ed[ED_NEXT][eidx])
        return 0

    def connect_rdnode(self, rid: int, pos: int) -> None:
        """Link read rid's nodes pos-1 -> pos (connect_rdnode_bspoa)."""
        self._encap_edges(4)
        NR.g_connect(self, self.rdnode(rid, pos - 1), self.rdnode(rid, pos))

    def disconnect_rdnode(self, rid: int, pos: int) -> None:
        """Unlink read rid's nodes pos-1 -> pos (disconnect_rdnode_bspoa)."""
        NR.g_disconnect(self, self.rdnode(rid, pos - 1),
                        self.rdnode(rid, pos))

    def cut_rdnode(self, rid: int, pos: int, cut: int) -> int:
        """BSPOA_RDNODE_CUT{EDGE=1,NODE=2,ALL=3} (bspoa.h:741-795)."""
        nd = self._nd
        nidx = self.rdnode(rid, pos)
        deg = int(nd[ND_NOU][nidx]) + int(nd[ND_NIN][nidx]) + 2
        self._encap_edges(4 * deg + 16)
        return NR.g_cut_rdnode(self, nidx, cut)

    def merge_nodes(self, n1: int, n2: int) -> int:
        """Union two aligned rings (bspoa.h:797-894); returns new header."""
        nd = self._nd
        h1 = int(nd[ND_HEADER][n1])
        h2 = int(nd[ND_HEADER][n2])
        deg = (int(nd[ND_NOU][h1]) + int(nd[ND_NIN][h1])
               + int(nd[ND_NOU][h2]) + int(nd[ND_NIN][h2]) + 2)
        self._encap_edges(4 * deg + 16)
        return NR.g_merge_nodes(self, n1, n2)

    def iter_edges(self, u: int, rev: bool):
        nd = self._nd
        ed = self._ed
        eidx = int(nd[ND_EREV][u] if rev else nd[ND_EDGE][u])
        nxt = ed[ED_NEXT]
        while eidx:
            n2 = int(nxt[eidx])
            yield eidx, EdgeRef(self, eidx)
            eidx = n2
