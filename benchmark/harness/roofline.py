"""Peaks of the card and the work of an alignment, counted from the DP's
shape, so that the count reads the same whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit: 3.35 TB/s of HBM3
and 67 TFLOP/s of float32 outside the tensor cores. The DP is 32-bit (and
narrower) integer work, which the card issues no faster than float32, so
the operation bound is a lower bound of the time. A card set below 700 W
runs slower under load: the benchmark prints the card's power limit beside
every share (device.power_limit).

Work of one banded alignment of a query on a target of tlen bases at band
BW: tlen x BW cells. Operations a cell, from the recurrence: the query
score's lookup, the diagonal's add, E's open and extend adds and their max,
F's the same, and the maxima that join them into H: 10 for affine gaps;
the second gap piece adds Q and G (3 each) and their two maxima: 18. Bytes:
both sequences read once at a byte a base, and the traceback data written
once at a fixed format: 4 bits a cell for affine gaps (a direction and two
gap-open bits), 3 bytes a cell for 2-piece gaps (the u, e and q planes
that backcal reads).
"""
from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_CELL = {1: 10, 2: 18}
TRACEBACK_BYTES_PER_CELL = {1: 0.5, 2: 3.0}


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, which bound) for ops operations and nbytes moved."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def align_work(pairs: Iterable[Tuple[int, int, int]],
               piecewise: int) -> Tuple[float, float, float]:
    """(operations, bytes, cells) of aligning pairs given as (query
    length, target length, band)."""
    cells = nbytes = 0.0
    for qlen, tlen, band in pairs:
        cells += float(tlen) * band
        nbytes += qlen + tlen
    nbytes += cells * TRACEBACK_BYTES_PER_CELL[piecewise]
    return cells * OPS_PER_CELL[piecewise], nbytes, cells
