"""The long-read reference and the port's two-pass mode, on the CPU:

- `benchmark/references/banded_align_long.py`, with its rows kept as
  int32 or computed again from the states kept every few rows, gives
  exactly `banded_align.py`'s answers on seeded pairs of 200-1,500 bp:
  overlap, global and extend, -W 0, a band wider than the query and bands
  that move, affine and 2-piece gaps, with blocks small enough that each
  traceback crosses many and reads past the band positions first copied;
- the port's two-pass mode (`align/pairwise._twopass_batch`, forced by
  small T_CHUNK and REALIGN_T) gives exactly the long reference's answers;
- its counters count what they say: `e2e_fetch` the bytes of the codes
  and band starts the walker is handed, `twopass_launch` and
  `e2e_traceback` one add a launch group with the group's pairs,
  `twopass_score` the DP cells, `banded8_refwd` one add a chunk.

Both references are loaded by path, as the benchmark's harness loads
them.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.constants import MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.oracle import banded8 as O
from bsalign_tpu_torch.utils import metrics

from .util import gen_pair

torch.set_num_threads(1)

REFS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "references")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_references_{name}", os.path.join(REFS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHORT = _load("banded_align")
LONG = _load("banded_align_long")
DEFAULT = (2, -6, -3, -2)                  # -M 2 -X 6 -O 3 -E 2
MAPONT = (2, -4, -4, -2, -24, -1)          # -M 2 -X 4 -O 4,24 -E 2,1
MODE_NAMES = {MODE_GLOBAL: "global", MODE_OVERLAP: "overlap"}

# (mode, -W, costs, target lengths, rows between kept states)
CASES = [("overlap", 0, DEFAULT, (1500, 420), 64),
         ("global", 0, DEFAULT, (1200, 230), 7),
         ("overlap", 2048, DEFAULT, (900, 200), 5),
         ("global", 2048, DEFAULT, (640,), 33),
         ("global", 128, MAPONT, (1000, 350), 50),
         ("overlap", 96, DEFAULT, (800,), 16),
         ("extend", 256, DEFAULT, (700,), 100)]


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_long_reference_matches_reference(case, keep):
    """keep: every row kept as int32, or the state entering each block and
    the rows computed again."""
    mode, W, costs, lens, block = CASES[case]
    rng = np.random.default_rng(1800 + case)
    for L in lens:
        q, t = gen_pair(rng, L, 0.12)
        f, cg = LONG.align(q, t, mode, W, *costs, block=block, device="cpu",
                           keep=keep)
        assert (f, cg) == SHORT.align(q, t, mode, W, *costs)
        assert f["aln"] >= L // 2


@pytest.mark.parametrize("keep", [True, False])
def test_long_reference_global_pays_for_leading_gaps(keep):
    """Global pairs whose query starts 40 bases into the target, or the
    target 40 into the query: the column and the row before the first
    hold the gap's cost, which the path must pay."""
    rng = np.random.default_rng(41)
    q, t = gen_pair(rng, 500, 0.08)
    lead = rng.integers(0, 4, 40).astype(np.uint8)
    for q, t in ((q, np.concatenate([lead, t])),
                 (np.concatenate([lead, q]), t)):
        want = SHORT.align(q, t, "global", 0, *DEFAULT)
        assert LONG.align(q, t, "global", 0, *DEFAULT, block=9,
                          device="cpu", keep=keep) == want


def _walk(q, t, W, block, keep):
    """The long reference's forward and backcal of a global pair at band
    W, with its rows."""
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    mtx = LONG.score_matrix(2, -6)
    dp = LONG._DP(q, t, LONG.MODES["global"], W, mtx, -3, -2, 0, 0, 1,
                  torch.device("cpu"))
    rows, res = LONG.forward(dp, block, keep)
    got = LONG.BA.backcal(q, t, 0, W, mtx, -3, -2, 0, 0, 1, rows, dp.Hinit,
                          dp.us00, res)
    assert got == SHORT.align(q, t, "global", W, 2, -6, -3, -2)
    return rows


def test_long_reference_tracebacks_cross_blocks():
    """A traceback reads rows of every block on its path: each block's rows
    computed once from its kept state, or none computed again where every
    row is kept."""
    q, t = gen_pair(np.random.default_rng(7), 600, 0.12)
    rows = _walk(q, t, 640, 10, False)
    assert len(rows.kept) == -(-len(t) // 10) and rows.store is None
    assert rows.computed == len(rows.kept)
    rows = _walk(q, t, 640, 10, True)
    assert rows.computed == 0 and not rows.kept


def test_long_reference_reads_past_its_window(monkeypatch):
    """A 300-base insertion: the traceback's search for the run's start
    reads past the band positions first copied of its block (2 x 2 + 256
    around the entry), and then copies the whole band."""
    rng = np.random.default_rng(31)
    t = rng.integers(0, 4, 500).astype(np.uint8)
    q = np.concatenate([t[:250], rng.integers(0, 4, 300), t[250:]])
    widths = []
    real = LONG._Block._copy
    monkeypatch.setattr(LONG._Block, "_copy", lambda self, lo, hi:
                        widths.append(hi - lo) or real(self, lo, hi))
    _walk(q, t, 1024, 2, True)
    assert 1024 in widths


def _answer(rs, cigar):
    return ({"score": rs.score, "qb": rs.qb, "qe": rs.qe, "tb": rs.tb,
             "te": rs.te, "mat": rs.mat, "mis": rs.mis, "ins": rs.ins,
             "dele": rs.dele, "aln": rs.aln}, [int(c) for c in cigar])


def _long_batch(rng):
    """A 40-base deletion across the chunk boundary at 256 (target rows
    230-269), a pair that ends in the second chunk and a noisy pair: T =
    384 rows, three chunks of 128."""
    t = rng.integers(0, 4, 380).astype(np.uint8)
    pairs = [(np.concatenate([t[:230], t[270:]]), t),
             gen_pair(rng, 200, 0.15), gen_pair(rng, 370, 0.18)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.fixture
def twopass(monkeypatch):
    """Rows chunks of 128 and two-pass past 128 rows; counts the two-pass
    groups."""
    monkeypatch.setattr(P, "T_CHUNK", 128)
    monkeypatch.setattr(P, "REALIGN_T", 128)
    groups = []
    real = P._twopass_batch
    monkeypatch.setattr(P, "_twopass_batch", lambda *a, **k: groups.append(
        len(a[11])) or real(*a, **k))
    return groups


@pytest.mark.parametrize("mode", [MODE_OVERLAP, MODE_GLOBAL])
def test_twopass_matches_long_reference(twopass, mode):
    qs, ts = _long_batch(np.random.default_rng(23))
    mtx = O.set_score_matrix(2, -6)
    got = P.align_batch(qs, ts, mode, 384, mtx, -3, -2, 0, 0, device="cpu")
    assert twopass == [3]
    for b, (q, t) in enumerate(zip(qs, ts)):
        want = LONG.align(q, t, MODE_NAMES[mode], 384, *DEFAULT, block=50,
                          device="cpu")
        assert _answer(*got[b]) == want, b


def test_twopass_counters(twopass, monkeypatch):
    """Groups of two pairs (the launch plan's rows per chunk kept): 3
    pairs in 2 groups, 3 chunks each."""
    plan = P._launch_plan
    monkeypatch.setattr(P, "_launch_plan", lambda *a: (2, plan(*a)[1]))
    handed = []
    walk = P.NR.walk_codes_chunk
    monkeypatch.setattr(P.NR, "walk_codes_chunk", lambda *a: handed.append(
        a[4].nbytes + a[5].nbytes) or walk(*a))
    qs, ts = _long_batch(np.random.default_rng(29))
    mtx = O.set_score_matrix(2, -6)
    metrics.reset()
    P.align_batch(qs, ts, MODE_OVERLAP, 384, mtx, -3, -2, 0, 0,
                  device="cpu")
    c = metrics.counters()
    metrics.reset()
    assert twopass == [2, 1]
    assert "banded8_fwd" not in c
    assert (c["twopass_launch"].calls, c["twopass_launch"].cells) == (2, 3)
    assert (c["e2e_traceback"].calls, c["e2e_traceback"].cells) == (2, 3)
    assert len(handed) == c["e2e_fetch"].calls == 6
    assert c["e2e_fetch"].cells == sum(handed)
    # codes [rows, ceil(W / 8), 16, pairs] and begs [rows, pairs], int32
    assert sum(handed) == 384 * 3 * (3 * 16 + 1) * 4
    assert c["banded8_refwd"].calls == 6
    cells = sum(len(t) for t in ts) * 384
    assert (c["twopass_score"].calls, c["twopass_score"].cells) == (2, cells)
    assert c["banded8_refwd"].cells == 384 * 3 * 384
