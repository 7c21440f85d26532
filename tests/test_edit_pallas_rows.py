"""Parity of the Pallas edit kernel's banded body with the XLA edit engine
at a few rows a grid step: test_edit_pallas.py's banded case (global, band
64, skewed lengths) with the kernel built at `Rs` rows a step instead of its
default 16. On the CPU the kernel runs in interpret mode, where the case at
16 rows a step takes longer than a tier-1 run and is marked slow (see the
root conftest.py); at 2 and 4 rows a step it takes seconds, over 320 and 160
grid steps of the pairs' 640 padded rows."""
import functools

import pytest

from bsalign_tpu.align import editdist as E
from bsalign_tpu.ops import edit_pallas
from bsalign_tpu.oracle import edit as OE

from .test_edit_pallas import _gen


@pytest.mark.parametrize("Rs", [2, 4])
def test_banded_edit_pallas_matches_jax_by_row_step(monkeypatch, Rs):
    mode, bw = 0, 64
    qs, ts = _gen(5, 350, 0.15, 11, True)
    # the band cuts every pair's matrix
    assert all(OE._select_bandwidth(len(q), len(t), mode, bw) < len(q)
               for q, t in zip(qs, ts))
    monkeypatch.setenv("BSA_FORWARD_ENGINE", "jax")
    rj = E.edit_batch(qs, ts, mode, bw)
    monkeypatch.setenv("BSA_FORWARD_ENGINE", "pallas")
    monkeypatch.setattr(edit_pallas, "make_edit_forward",
                        functools.partial(edit_pallas.make_edit_forward,
                                          Rs=Rs))
    rp = E.edit_batch(qs, ts, mode, bw)
    for (ra, ca), (rb, cb) in zip(rj, rp):
        assert (ra.score, ra.qb, ra.qe, ra.tb, ra.te) == \
            (rb.score, rb.qb, rb.qe, rb.tb, rb.te)
        assert ca == cb
