"""Driver of `align`: the port's align path below file I/O.

A call aligns one batch of pairs as `bsalign_tpu_torch align` does for the
pairs of one input file: pairs are bucketed by band (-W, or at -W 0 the
query's length rounded up to 128) and each bucket is one
`bsalign_tpu_torch.align.pairwise.align_batch` call on the card, which
runs a bucket of more than 256 pairs as its depth-2 pipeline of chunks;
answers come back in input order, on the host, with their CIGARs walked.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class Driver:
    def __init__(self, config: dict, device):
        from bsalign_tpu_torch.align import pairwise
        from bsalign_tpu_torch.constants import MODE_NAMES
        from bsalign_tpu_torch.oracle import banded8
        from bsalign_tpu_torch.utils import metrics
        a = config["align"]
        self._align_batch = pairwise.align_batch
        self._metrics = metrics
        self.mode = MODE_NAMES[a["mode"]]
        self.W = a["W"]
        self.mtx = banded8.set_score_matrix(a["M"], -a["X"])
        self.gaps = (-a["O"], -a["E"], -a["Q"], -a["P"])
        self.device = device
        # the host work after the device's results are fetched: the codes
        # walker, or backcal over the 2-piece planes
        pw = banded8.get_piecewise(*self.gaps, 1 << 30)
        self.host_after = "backcal" if pw == 2 else "walk"

    def mark_phases(self) -> None:
        """For a traced run: wrap the program's host phases of a chunk in
        profiler spans `bench.<phase>`: "pack" (pack, operands, launch),
        the host work after it ("walk" or "backcal": the fetch and the
        tracebacks) and, inside it, "results" (the forward's scores read
        into results, with the overlap row maximum). A phase whose
        function the program no longer has is left unmarked."""
        from torch.profiler import record_function
        from bsalign_tpu_torch.align import pairwise

        def marked(f, name):
            def g(*args, **kw):
                with record_function(name):
                    return f(*args, **kw)
            g.bench_marked = True
            return g

        for fn, phase in (("_launch_batch", "pack"),
                          ("_finish_batch", self.host_after),
                          ("_base_results", "results")):
            f = getattr(pairwise, fn, None)
            if f is not None and not getattr(f, "bench_marked", False):
                setattr(pairwise, fn, marked(f, "bench." + phase))

    def _buckets(self, pairs: Sequence[Tuple]) -> Dict[int, List[int]]:
        buckets: Dict[int, List[int]] = {}
        for i, (q, _) in enumerate(pairs):
            bw = self.W if self.W > 0 else -(-len(q) // 128) * 128
            buckets.setdefault(bw, []).append(i)
        return buckets

    def call(self, pairs: Sequence[Tuple]) -> List:
        out = [None] * len(pairs)
        for bw, idx in self._buckets(pairs).items():
            res = self._align_batch([pairs[i][0] for i in idx],
                                    [pairs[i][1] for i in idx], self.mode, bw,
                                    self.mtx, *self.gaps, device=self.device)
            for i, r in zip(idx, res):
                out[i] = r
        return out

    @staticmethod
    def answer(out: List, j: int):
        """Pair j's answer in the reference's form: (fields, CIGAR)."""
        rs, cigars = out[j]
        return ((rs.score, rs.qb, rs.qe, rs.tb, rs.te, rs.mat, rs.mis,
                 rs.ins, rs.dele, rs.aln), tuple(int(c) for c in cigars))

    def counters(self) -> Dict[str, Dict[str, float]]:
        return {k: {"cells": c.cells, "seconds": c.seconds, "calls": c.calls}
                for k, c in self._metrics.counters().items()}

    def reset_counters(self) -> None:
        self._metrics.reset()
