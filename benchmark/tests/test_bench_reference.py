"""The plain reference against alignments checked by hand."""
import pytest

from harness import core

ref = core.load_module("references", "banded_align")
DEFAULT = (2, -6, -3, -2)                  # -M 2 -X 6 -O 3 -E 2
MAPONT = (2, -4, -4, -2, -24, -1)          # -M 2 -X 4 -O 4,24 -E 2,1


def enc(s):
    return ["ACGT".index(c) for c in s]


def cig(*runs):
    return [(n << 4) | "MID".index(op) for n, op in runs]


@pytest.mark.parametrize("q, t, mode, W, costs, fields, cigar", [
    # identical: 4 matches
    ("ACGT", "ACGT", "global", 0, DEFAULT,
     (8, 0, 4, 0, 4, 4, 0, 0, 0, 4), cig((4, "M"))),
    # one of the target's two Cs deleted: 7 x 2 - (3 + 2); backcal walks
    # from the end and matches while it can, so the gap sits left
    ("AACGGTT", "AACCGGTT", "global", 0, DEFAULT,
     (9, 0, 7, 0, 8, 7, 0, 0, 1, 8), cig((2, "M"), (1, "D"), (5, "M"))),
    # overlap: the query's last 8 bases on the target's first 8, free ends
    ("GGGGACGTACGT", "ACGTACGTTTTT", "overlap", 0, DEFAULT,
     (16, 4, 12, 0, 8, 8, 0, 0, 0, 8), cig((8, "M"))),
    # a 30-base deletion costs the second piece, 24 + 30, not 4 + 2 x 30
    ("ACGT" * 5 + "GCAT" * 5, "ACGT" * 5 + "C" * 30 + "GCAT" * 5, "global",
     64, MAPONT, (26, 0, 40, 0, 70, 40, 0, 0, 30, 70),
     cig((20, "M"), (30, "D"), (20, "M"))),
])
def test_bench_reference_hand_checked(q, t, mode, W, costs, fields, cigar):
    f, cg = ref.align(enc(q), enc(t), mode, W, *costs)
    assert tuple(f[k] for k in ref.FIELDS) == fields
    assert cg == cigar


def test_bench_reference_control_moves_the_gap_only():
    """The control breaks ties toward the gap: the same score, the gap one
    base later."""
    f, cg = ref.align(enc("AACGGTT"), enc("AACCGGTT"), "global", 0, *DEFAULT,
                      gap_first=True)
    assert f["score"] == 9
    assert cg == cig((3, "M"), (1, "D"), (4, "M"))


def test_bench_reference_bands():
    assert ref.band_of(1970, 0) == 2048
    assert ref.band_of(1920, 0) == 1920
    assert ref.band_of(2000, 500) == 512
    assert ref.piecewise(-4, -2, -24, -1, 512) == 2
    assert ref.piecewise(-3, -2, 0, 0, 2048) == 1
