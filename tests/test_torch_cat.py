"""The port's `cat` against bsalign_tpu's, on the CPU.

`bsalign_tpu_torch cat --device cpu` and `bsalign_tpu.cli cat` run in
process on the same seeded pieces and must print the same bytes
(tolerance 0: text). The JAX package aligns each join with its scalar
oracle; the port with `align_batch`, whose CPU path is the banded-8
kernel's plain version. Cases: clean joins, a stated overlap= of half the
real one (the 4x retry), a pair with no true overlap (6 N inserted), a
piece shorter than the window, N in the consensus side of later joins,
-o, and the defaults against the same values given as flags. A piece
with an N in the window its join aligns is refused by both; an N inside a
run of inserted bases of the consensus is accepted by both unless it is
the base the traceback scores (the run's last, every base at -O 0).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from bsalign_tpu.poa import cat as JCAT
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.poa import cat as TCAT

torch.set_num_threads(1)

BASES = "ACGT"


def _mutate(rng, s, err):
    """s with independent substitutions, insertions and deletions."""
    out, i = [], 0
    while i < len(s):
        r = rng.random()
        if r < err / 3:
            out.append((int(s[i]) + int(rng.integers(1, 4))) & 3)
            i += 1
        elif r < 2 * err / 3:
            out.append(int(rng.integers(0, 4)))
        elif r < err:
            i += 1
        else:
            out.append(int(s[i]))
            i += 1
    return np.array(out, np.uint8)


def _pieces(seed, spans, err=0.02, reflen=None):
    """Pieces [lo, hi) of one seeded contig, each with its own errors."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, reflen or max(hi for _, hi in spans))
    ref = ref.astype(np.uint8)
    return [_mutate(rng, ref[lo:hi], err) for lo, hi in spans], rng


def _fasta(path, pieces, descs=None):
    with open(path, "w") as f:
        for i, p in enumerate(pieces):
            seq = p if isinstance(p, str) else "".join(BASES[b] for b in p)
            d = f" {descs[i]}" if descs and descs[i] else ""
            f.write(f">w{i}{d}\n{seq}\n")
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(argv):
    """(jax stdout, port stdout) of `cat argv`; both must exit 0."""
    rj, oj = _run(JCAT.run_cat, argv)
    rt, ot = _run(TCLI.main, ["cat", "--device", "cpu"] + argv)
    assert rj == 0 and rt == 0
    return oj, ot


def _cases(tmp):
    """(name, argv) of every byte-identity case."""
    out = []
    # clean joins: 4 windows of 300 overlapping by 100
    p, _ = _pieces(1, [(0, 300), (200, 500), (400, 700), (600, 900)])
    out.append(("clean", ["-W", "100", _fasta(tmp / "clean.fa", p)]))
    # the second piece states half its real overlap: the 4x retry
    p, _ = _pieces(2, [(0, 300), (180, 480), (380, 680)])
    out.append(("retry", ["-W", "100", _fasta(
        tmp / "retry.fa", p, [None, "overlap=60", "len=300 overlap=100"])]))
    # no true overlap between pieces 1 and 2: 6 N inserted
    p, rng = _pieces(3, [(0, 250), (150, 400)])
    p.append(rng.integers(0, 4, 260).astype(np.uint8))
    out.append(("no-overlap", ["-W", "100", _fasta(tmp / "noov.fa", p)]))
    # a piece shorter than the window
    p, _ = _pieces(4, [(0, 260), (200, 270), (230, 480)])
    out.append(("short", ["-W", "100", _fasta(tmp / "short.fa", p)]))
    # N in the consensus side of later joins, off their paths: the 6 N of
    # a failed join and an N of the input, both in the query window of the
    # next join but before the base where its piece starts
    p, rng = _pieces(5, [(0, 250)])
    b = rng.integers(0, 4, 400).astype(np.uint8)
    c = np.concatenate([b[300:], rng.integers(0, 4, 200).astype(np.uint8)])
    b = "".join(BASES[x] for x in b)
    b = b[:250] + "N" + b[251:]
    out.append(("n-in-cns", ["-W", "200", _fasta(tmp / "ncns.fa",
                                                  [p[0], b, c])]))
    return out


@pytest.mark.parametrize("case", ["clean", "retry", "no-overlap", "short",
                                  "n-in-cns"])
def test_cat_same_bytes(tmp_path, monkeypatch, case):
    argv = dict(_cases(tmp_path))[case]
    calls = []

    def spy(qs, ts, *args, **kw):
        calls.append((len(qs[0]), int(qs[0].max()), len(ts[0])))
        return align_batch(qs, ts, *args, **kw)
    align_batch = TCAT.align_batch
    monkeypatch.setattr(TCAT, "align_batch", spy)
    oj, ot = _both(argv)
    assert ot == oj and ot.startswith(">cns len=")
    seq = "".join(ot.splitlines()[1:])
    joins = {"clean": 3, "retry": 2, "no-overlap": 2, "short": 2,
             "n-in-cns": 2}[case]
    if case == "retry":
        # one retry, at 4x the stated overlap of 60
        assert len(calls) == joins + 1 and calls[1][0] == 240
        assert "N" not in seq
    elif case == "n-in-cns":
        assert seq.count("NNNNNN") == 1 and seq.count("N") == 7
        assert calls[-1][1] == 4     # the last join's query holds N
    else:
        assert len(calls) >= joins
    if case == "no-overlap":
        assert "NNNNNN" in seq
    if case == "short":
        assert calls[0][2] == 70 < 100


def test_cat_out_file_and_defaults(tmp_path):
    """-o writes the same file as the JAX package's; the port with no
    flags prints it too, and so does the port with the defaults given as
    flags (-W 1024 -M 2 -X -6 -O -3 -E -2, passed on unnegated)."""
    p, _ = _pieces(6, [(0, 130), (80, 210), (160, 290)])
    fa = _fasta(tmp_path / "d.fa", p)
    rj, oj = _run(JCAT.run_cat, ["-o", str(tmp_path / "j.fa"), fa])
    rt, ot = _run(TCLI.main, ["cat", "--device", "cpu", "-o",
                              str(tmp_path / "t.fa"), fa])
    assert rj == rt == 0 and oj == ot == ""
    want = (tmp_path / "j.fa").read_text()
    assert want.startswith(">cns len=")
    assert (tmp_path / "t.fa").read_text() == want
    explicit = ["-W", "1024", "-M", "2", "-X", "-6", "-O", "-3", "-E", "-2"]
    for flags in ([], explicit):
        rt, ot = _run(TCLI.main, ["cat", "--device", "cpu"] + flags + [fa])
        assert rt == 0 and ot == want


def test_cat_refuses_n_in_the_join_window(tmp_path, capsys):
    """An N within the first W bases of a piece: the JAX package's oracle
    raises (IndexError in its forward), the port exits 1 naming the piece
    before any launch."""
    p, _ = _pieces(7, [(0, 250), (150, 400)])
    s = "".join(BASES[x] for x in p[1])
    fa = _fasta(tmp_path / "n.fa", [p[0], s[:40] + "N" + s[41:]])
    with pytest.raises(IndexError):
        _run(JCAT.run_cat, ["-W", "100", fa])
    rc, out = _run(TCLI.main, ["cat", "--device", "cpu", "-W", "100", fa])
    assert rc == 1 and out == ""
    assert "'w1'" in capsys.readouterr().err


def test_cat_refuses_n_on_the_join_path(tmp_path, capsys):
    """An N of the consensus inside the overlap its next piece aligns to:
    the JAX package's oracle raises in its traceback (IndexError), the
    port exits 1 after the walk, naming the piece."""
    p, _ = _pieces(8, [(0, 250), (150, 400)])
    s = "".join(BASES[x] for x in p[0])
    fa = _fasta(tmp_path / "q.fa", [s[:200] + "N" + s[201:], p[1]])
    with pytest.raises(IndexError):
        _run(JCAT.run_cat, ["-W", "100", fa])
    rc, out = _run(TCLI.main, ["cat", "--device", "cpu", "-W", "100", fa])
    assert rc == 1 and out == ""
    assert "'w1'" in capsys.readouterr().err


def test_walked_query_covers_the_path():
    """The query positions the refusal checks: every base of M ops, the
    last base of each I op (every base without a gap open cost) and the
    base before each D op."""
    from bsalign_tpu_torch.cigar import AlnResult
    rs = AlnResult(qb=3, qe=12)
    cg = [(4 << 4) | 0, (2 << 4) | 2, (2 << 4) | 1, (3 << 4) | 0]
    assert TCAT._walked_query(rs, cg) == [3, 4, 5, 6, 6, 8, 9, 10, 11]
    assert TCAT._walked_query(rs, cg, False) == [3, 4, 5, 6, 6, 7, 8, 9,
                                                 10, 11]


def _jax_cli(argv):
    """(exit code, stdout) of `bsalign_tpu.cli cat argv`, run in process:
    the IndexError with which the JAX package's oracle refuses a join ends
    that CLI with exit code 1 and no output."""
    from bsalign_tpu import cli as JCLI
    try:
        return _run(JCLI.main_cat, argv)
    except IndexError:
        return 1, ""


# a run of 5 bases inserted into the consensus inside the next join's
# overlap, one of them N: accepted by both where the traceback consumes
# the N unscored, refused by both where it scores it (the run's last base;
# at -O 0 every base, each a run of its own)
@pytest.mark.parametrize("gaps,npos", [((), 0), ((), 2), ((), 4),
                                       (("-O", "0"), 2)])
def test_cat_n_in_an_insertion_run(tmp_path, capsys, gaps, npos):
    p, _ = _pieces(11, [(0, 300), (200, 500)], err=0.0)
    s0 = "".join(BASES[x] for x in p[0])
    run = "GTCAT"
    s0 = s0[:260] + run[:npos] + "N" + run[npos + 1:] + s0[260:]
    argv = ["-W", "100", *gaps, _fasta(tmp_path / "ins.fa", [s0, p[1]])]
    rj, oj = _jax_cli(argv)
    rt, ot = _run(TCLI.main, ["cat", "--device", "cpu"] + argv)
    assert (rt, ot) == (rj, oj)
    accepted = not gaps and npos < 4
    assert rt == (0 if accepted else 1)
    if accepted:
        assert ot.startswith(">cns len=")
        # the join's one I op holds the N, away from its last base
        q = np.array(["ACGTN".index(c) for c in s0[-100:]], np.uint8)
        [(rs, cg)] = TCAT.align_batch([q], [p[1][:100]], TCAT.MODE_OVERLAP,
                                      100 + 12, TCAT.B8.set_score_matrix(
                                          2, -6), -3, -2, 0, 0, device="cpu")
        x, ins = rs.qb, []
        for c in cg:
            if c & 0xF != 2:
                if c & 0xF == 1:
                    ins.append((x, x + (c >> 4)))
                x += c >> 4
        n = int(np.flatnonzero(q == 4)[0])
        assert any(a <= n < b - 1 for a, b in ins), (ins, n)
    else:
        assert "'w1'" in capsys.readouterr().err
