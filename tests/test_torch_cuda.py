"""The hand-written CUDA kernels (banded-8, edit, pedit) against their
plain PyTorch versions, on one CUDA device. Every test here needs the card and
nvcc: it carries the `cuda` marker and skips without a CUDA device. The
file imports no jax, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

All comparisons are exact: the arithmetic is integer.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch import cli as CLI
from bsalign_tpu_torch.align import pairwise as P
from bsalign_tpu_torch.constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.ops import banded8 as K
from bsalign_tpu_torch.oracle import banded8 as O

from .util import gen_pair

pytestmark = pytest.mark.cuda

AFFINE = (-3, -2, 0, 0)   # piecewise 1
LINEAR = (0, -4, 0, 0)    # piecewise 0
TWO_PIECE = (-4, -2, -24, -1)  # piecewise 2 (map-ont: -O 4 -E 2 -Q 24 -P 1)
NT_MAX, NT_MIN = 2, -6

# (mode, gaps, W, pair lengths, error rate, seed)
CASES = [
    (MODE_GLOBAL, LINEAR, 1, (90, 120, 150), 0.12, 1),
    (MODE_GLOBAL, AFFINE, 2, (90, 160, 220), 0.12, 2),
    (MODE_OVERLAP, AFFINE, 8, (150, 200, 240), 0.12, 5),
    (MODE_EXTEND, AFFINE, 1, (90, 100, 120), 0.12, 8),
    (MODE_EXTEND, LINEAR, 2, (100, 130, 170), 0.25, 12),
    (MODE_GLOBAL, AFFINE, 8, (150, 200, 250, 300), 0.25, 10),
    (MODE_OVERLAP, AFFINE, 40, (600, 600, 620), 0.10, 13),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def _pairs(lens, err, seed):
    rng = np.random.default_rng(seed)
    return [list(x) for x in zip(*(gen_pair(rng, L, err) for L in lens))]


def _operands(qs, ts, mode, gaps, W):
    bw = W * 16
    pw = O.get_piecewise(*gaps, bw)
    qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bw)
    us, es, q0, ub, _ = P._init_state(mode, bw, pw, NT_MAX, NT_MIN, *gaps,
                                      len(qs))
    mtx5 = P._mtx5(O.set_score_matrix(NT_MAX, NT_MIN))
    return pw, T, (qpad, qlens, tpad, tlens, mtx5, rby, us, es, q0, ub)


def _kernel_and_plain(g, args, device):
    from bsalign_tpu_torch.ops import _cuda
    st = K.state_from_numpy(*args, T=g.T, device=device)
    rk = _cuda.banded8_rows(g, st)
    rp = K.forward_plain(g, st)
    torch.cuda.synchronize()
    return rk, rp


def _assert_same(rk, rp):
    assert sorted(rk) == sorted(rp)
    for fld, a in rk.items():
        if fld == "fin_planes":
            assert len(a) == len(rp[fld])
            for x, c in zip(a, rp[fld]):
                assert torch.equal(x, c), fld
        elif a is not None:
            assert torch.equal(a, rp[fld]), fld


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(case, cuda_device):
    mode, gaps, W, lens, err, seed = CASES[case]
    qs, ts = _pairs(lens, err, seed)
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, "codes")
    _assert_same(*_kernel_and_plain(g, args, cuda_device))


@pytest.mark.parametrize("gaps", [AFFINE, LINEAR, (-4, -2, -10, -1)])
def test_kernel_full_band_reset_matches_plain(gaps, cuda_device):
    """qlen >> tlen at band 16: the global steering moves the band past its
    width, so the band is fully reset. Piecewise 2 at band 16 needs a
    first gap piece shorter than the band (-Q 10 -P 1), and emits planes."""
    rng = np.random.default_rng(21)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (800, 900, 700)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
    pw, T, args = _operands(qs, ts, MODE_GLOBAL, gaps, 1)
    g = K.Geometry(T, 1, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN,
                   "planes" if pw == 2 else "codes")
    rk, rp = _kernel_and_plain(g, args, cuda_device)
    begs = rk["begs"].cpu().numpy()
    assert max(np.diff(begs[:40, b], prepend=0).max() for b in range(3)) >= 16
    _assert_same(rk, rp)


def test_make_forward_on_cuda_launches_and_matches_cpu(cuda_device):
    """The wrapper on a CUDA device launches the kernel (counted once per
    launch) and gives the CPU path's ForwardResult."""
    from bsalign_tpu_torch.ops import _cuda
    mode, gaps, W, lens, err, seed = CASES[2]
    qs, ts = _pairs(lens, err, seed)
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    geom = (T, W, mode, pw, *gaps, NT_MAX, NT_MIN)
    before = _cuda.launches_codes
    rg = K.make_forward(*geom, codes=True, device=cuda_device)(*args)
    assert _cuda.launches_codes == before + 1
    rc = K.make_forward(*geom, codes=True, device="cpu")(*args)
    assert _cuda.launches_codes == before + 1
    for fld in ("score", "qe", "te", "final_us", "final_ubegs", "final_rbeg",
                "final_reg"):
        assert torch.equal(getattr(rg, fld), getattr(rc, fld)), fld
    assert torch.equal(rg.planes.codes, rc.planes.codes)
    assert torch.equal(rg.planes.begs, rc.planes.begs)


def test_kernel_wrapper_checks_operands(cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    mode, gaps, W, lens, err, seed = CASES[1]
    qs, ts = _pairs(lens, err, seed)
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    st = K.state_from_numpy(*args, T=T, device=cuda_device)
    st = st._replace(qlen=st.qlen.long())
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, "codes")
    before = _cuda.launches_codes
    with pytest.raises(ValueError, match="qlen"):
        _cuda.banded8_rows(g, st)
    assert _cuda.launches_codes == before


@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
def test_align_batch_cuda_matches_cpu(mode, cuda_device):
    qs, ts = _pairs((150, 220, 300, 180), 0.12, 30 + mode)
    mtx = O.set_score_matrix(NT_MAX, NT_MIN)

    def tsv(device):
        out = P.align_batch(qs, ts, mode, 64, mtx, *AFFINE, device=device)
        return "".join(CLI._fmt_pairwise(f"q{b}", f"t{b}", qs[b], ts[b], rs, cg)
                       for b, (rs, cg) in enumerate(out))
    assert tsv(cuda_device) == tsv("cpu")


# (mode, gaps, W, pair lengths, error rate, seed): planes and none emits
EMIT_CASES = [
    (MODE_GLOBAL, LINEAR, 2, (90, 120, 150), 0.12, 51),
    (MODE_OVERLAP, AFFINE, 8, (150, 200, 240), 0.12, 52),
    (MODE_GLOBAL, TWO_PIECE, 8, (150, 200, 250, 300), 0.15, 53),
    (MODE_OVERLAP, TWO_PIECE, 2, (100, 160, 200), 0.12, 54),
    (MODE_EXTEND, TWO_PIECE, 40, (600, 600, 620), 0.10, 55),
]


@pytest.mark.parametrize("emit", ["planes", "none"])
@pytest.mark.parametrize("case", range(len(EMIT_CASES)))
def test_kernel_emits_match_plain(case, emit, cuda_device):
    mode, gaps, W, lens, err, seed = EMIT_CASES[case]
    qs, ts = _pairs(lens, err, seed)
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, emit)
    _assert_same(*_kernel_and_plain(g, args, cuda_device))


@pytest.mark.parametrize("emit", ["codes", "planes", "none"])
def test_kernel_resumed_chunks_match_one_shot(emit, cuda_device):
    """The kernel run in chunks of 64 rows, each resumed at its global row
    from the previous launch's final state, gives the one-shot launch's
    rows and final state; the shortest pair ends in an earlier chunk."""
    from bsalign_tpu_torch.ops import _cuda
    gaps = AFFINE if emit == "codes" else TWO_PIECE
    qs, ts = _pairs((120, 200, 250), 0.12, 56)
    pw, T, args = _operands(qs, ts, MODE_GLOBAL, gaps, 4)
    g = K.Geometry(T, 4, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN, emit)
    one = _cuda.banded8_rows(g, K.state_from_numpy(*args, T=T,
                                                    device=cuda_device))
    (qpad, qlens, tpad, tlens, mtx5, rby), state = args[:6], list(args[6:])
    reg, parts = None, []
    for c0 in range(0, T, 64):
        st = K.state_from_numpy(qpad, qlens, tpad[:, c0:c0 + 64], tlens,
                                mtx5, rby[c0:c0 + 64], *state, reg, c0, T=64,
                                device=cuda_device)
        r = _cuda.banded8_rows(g._replace(T=64), st)
        parts.append(r)
        state = (r["fin_planes"] + [None, None])[:3] + [r["fin_ub"]]
        reg = r["fin_reg"]
    torch.cuda.synchronize()
    joined = {k: (r[k] if k.startswith("fin") or r[k] is None
                  else torch.cat([p[k] for p in parts], 0)) for k in r}
    _assert_same(joined, one)


# (W, mode, gaps by emit): bands 16, 32, 48 and 144, whose last group of 8
# stripes is partial (W = 2 has one group, W = 9 a second of one stripe)
PARTIAL_GROUPS = [(1, MODE_GLOBAL), (2, MODE_OVERLAP), (3, MODE_EXTEND),
                  (9, MODE_GLOBAL)]
SHORT_TWO_PIECE = (-4, -2, -10, -1)   # piecewise 2 down to band 16


@pytest.mark.parametrize("emit", ["codes", "planes", "none"])
@pytest.mark.parametrize("case", range(len(PARTIAL_GROUPS)))
def test_kernel_partial_groups_match_plain(case, emit, cuda_device):
    """Every emit at W = 1, 2, 3 and 9, with query lengths at every residue
    mod 8 and a short query in the batch's last pair, where a read past its
    window would leave the query buffer."""
    W, mode = PARTIAL_GROUPS[case]
    gaps = {"codes": AFFINE, "planes": SHORT_TWO_PIECE, "none": LINEAR}[emit]
    qs, ts = _pairs(tuple(130 + 9 * k for k in range(8)) + (100,), 0.12,
                    70 + case)
    qs = [q[:101 + k] for k, q in enumerate(qs[:-1])] + [qs[-1][:13]]
    assert {len(q) % 8 for q in qs} == set(range(8))
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, emit)
    _assert_same(*_kernel_and_plain(g, args, cuda_device))


@pytest.mark.parametrize("emit", ["codes", "planes", "none"])
def test_kernel_cycle_split_leaves_outputs_alone(emit, cuda_device):
    """A launch with the cycle split on gives the outputs of one with it
    off, and counts cycles in every phase of every pair."""
    from bsalign_tpu_torch.ops import _cuda
    gaps = AFFINE if emit == "codes" else TWO_PIECE
    qs, ts = _pairs((150, 200, 250), 0.12, 75)
    pw, T, args = _operands(qs, ts, MODE_GLOBAL, gaps, 8)
    g = K.Geometry(T, 8, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN, emit)
    st = K.state_from_numpy(*args, T=T, device=cuda_device)
    on = _cuda.banded8_rows(g, st, cycle_split=True)
    off = _cuda.banded8_rows(g, st)
    torch.cuda.synchronize()
    cycles = on.pop("cycles")
    assert tuple(cycles.shape) == (len(_cuda.SPLIT_PHASES), 3)
    assert (cycles[:6] > 0).all()
    _assert_same(on, off)


@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_EXTEND])
def test_align_batch_two_piece_and_chunked_cuda_matches_cpu(mode,
                                                            cuda_device,
                                                            monkeypatch):
    """2-piece gaps through the planes emit, and the long-target routes
    forced by small T_CHUNK/REALIGN_T, give the CPU path's TSV."""
    from bsalign_tpu_torch.ops import _cuda
    qs, ts = _pairs((300, 450, 700, 520), 0.12, 57 + mode)
    mtx = O.set_score_matrix(NT_MAX, NT_MIN)

    def tsv(device, gaps):
        out = P.align_batch(qs, ts, mode, 64, mtx, *gaps, device=device)
        return "".join(CLI._fmt_pairwise(f"q{b}", f"t{b}", qs[b], ts[b], rs,
                                         cg)
                       for b, (rs, cg) in enumerate(out))
    before = _cuda.launches_planes
    assert tsv(cuda_device, TWO_PIECE) == tsv("cpu", TWO_PIECE)
    assert _cuda.launches_planes == before + 1
    monkeypatch.setattr(P, "T_CHUNK", 128)
    for realign_t in (256, 1024):    # two-pass, then chunked codes
        monkeypatch.setattr(P, "REALIGN_T", realign_t)
        assert tsv(cuda_device, AFFINE) == tsv("cpu", AFFINE)
    assert tsv(cuda_device, TWO_PIECE) == tsv("cpu", TWO_PIECE)


# ---- the edit kernel (csrc/edit.cu) ----

def _edit_operands(qs, ts, mode, bw, banded, device):
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.ops import edit as KE
    T, _, ops = D._pack_bucket(qs, ts, bw, banded)
    return (KE.Geometry(T, bw // 32, mode),
            KE.operands_from_numpy(*ops, T=T, device=device))


def _assert_edit_same(g, ops, design=None, geometry=None):
    """Kernel vs plain on rows < tlen of pm, pp and sbeg, and on the final
    planes, smin, ry, final sbeg, final rbeg and the global score whole
    (`design` forces a row of the kernel, `geometry` the block row's)."""
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import edit as KE
    rk = _cuda.edit_rows(g, ops, design=design, geometry=geometry)
    rp = KE.forward_plain(g, ops)
    torch.cuda.synchronize()
    for b, n in enumerate(ops.tlen.tolist()):
        for fld in ("pm", "pp", "sbeg"):
            assert torch.equal(rk[fld][b, :n], rp[fld][b, :n]), (fld, b)
    for fld in ("fin_pm", "fin_pp", "scal"):
        assert torch.equal(rk[fld], rp[fld]), fld
    assert torch.equal(KE.final_score(g, rk, ops.qlen),
                       KE.final_score(g, rp, ops.qlen))


# (mode, band bits, banded, pair lengths, seed): NW 1, 2, 3, 8 and 64
EDIT_CASES = [
    (MODE_GLOBAL, 32, True, (150, 190, 240), 1),
    (MODE_GLOBAL, 64, True, (150, 190, 240), 2),
    (MODE_GLOBAL, 96, True, (300, 250), 3),
    (MODE_GLOBAL, 256, False, (150, 200, 230), 4),
    (MODE_OVERLAP, 256, False, (150, 200, 230), 5),
    (MODE_EXTEND, 256, False, (150, 200, 230), 6),
    (MODE_GLOBAL, 2048, False, (2000, 1900), 7),
]


@pytest.mark.parametrize("case", range(len(EDIT_CASES)))
def test_edit_kernel_matches_plain(case, cuda_device):
    mode, bw, banded, lens, seed = EDIT_CASES[case]
    qs, ts = _pairs(lens, 0.12, seed)
    _assert_edit_same(*_edit_operands(qs, ts, mode, bw, banded, cuda_device))


@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_EXTEND])
def test_edit_kernel_full_band_reset_matches_plain(mode, cuda_device):
    """A hand-made trajectory whose band jumps by more than its width on
    some rows resets the planes, which driver trajectories rarely reach."""
    rng = np.random.default_rng(23)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (1500, 1200)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (200, 150)]
    g, ops = _edit_operands(qs, ts, mode, 64, True, "cpu")
    rbegs = np.zeros((g.T, 2), np.int32)
    for b, t in enumerate(ts):
        cur = 0
        for i in range(len(t)):
            cur += 64 + 7 * (i % 3) if i % 37 == 5 else (i % 11 == 3) * 13
            rbegs[i, b] = min(cur, len(qs[b]) - 8)
    movxs = np.diff(rbegs, axis=0, prepend=0).astype(np.int32)
    for b, t in enumerate(ts):
        movxs[len(t):, b] = 0
    assert movxs.max() >= 64
    ops = ops._replace(rbegs=torch.as_tensor(rbegs, device=cuda_device),
                       movxs=torch.as_tensor(movxs, device=cuda_device),
                       **{f: getattr(ops, f).to(cuda_device)
                          for f in ("qeq", "qlen", "tseq", "tlen")})
    _assert_edit_same(g, ops)


def test_edit_forward_on_cuda_launches_and_matches_cpu(cuda_device):
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.ops import _cuda
    qs, ts = _pairs((150, 220, 300, 180), 0.12, 40)
    before = _cuda.edit_launches
    rg = D.edit_batch(qs, ts, MODE_GLOBAL, 64, device=cuda_device)
    assert _cuda.edit_launches > before
    n = _cuda.edit_launches
    rc = D.edit_batch(qs, ts, MODE_GLOBAL, 64, device="cpu")
    assert _cuda.edit_launches == n
    for (a, ca), (c, cc) in zip(rg, rc):
        assert vars(a) == vars(c) and ca == cc


def test_edit_launcher_refuses_cpu_tensors(cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    qs, ts = _pairs((100, 120), 0.1, 41)
    g, ops = _edit_operands(qs, ts, MODE_GLOBAL, 256, False, "cpu")
    before = _cuda.edit_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.edit_rows(g, ops)
    assert _cuda.edit_launches == before


@pytest.mark.parametrize("mode", ["global", "overlap", "extend", "kmer"])
def test_edit_cli_cuda_matches_cpu(mode, cuda_device, tmp_path, capsys):
    from .util import write_pairs_fasta
    rng = np.random.default_rng(42)
    path = tmp_path / "p.fa"
    write_pairs_fasta(str(path), [gen_pair(rng, L, 0.12)
                                  for L in (150, 400, 900)])
    out = {}
    for dev in ("cuda", "cpu"):
        assert CLI.main(["edit", "-m", mode, "--device", dev, str(path)]) == 0
        out[dev] = capsys.readouterr().out
    assert out["cuda"] == out["cpu"] and out["cpu"].count("\n") == 12


# ---- pedit (csrc/pedit.cu) ----
def _pedit_jobs(kind):
    from .test_torch_pedit import _gen_window, _mk_job, _round_jobs
    rng = np.random.default_rng(31)
    if kind == "short":
        return [_mk_job(rng, int(rng.integers(8, 60)), 32, span=s)
                for s in (2, 1, 2, 1)]
    if kind == "window":
        return _round_jobs(_gen_window(rng, 8, 173))[0]
    if kind == "short-pad":
        # buffers cut to mlen + bw/2: cells past pad read the defaults
        out = []
        for j in (_mk_job(rng, int(rng.integers(30, 90)), 64)
                  for _ in range(4)):
            pad = j.mlen + 32
            out.append(type(j)(j.seqs0[:pad].copy(), j.seqs1[:pad].copy(),
                               j.mats0[:, :pad].copy(),
                               j.mats1[:, :pad].copy(), j.mlen, j.mbeg,
                               j.mend, j.bw, j.HW))
        return out
    bw = int(kind)
    return [_mk_job(rng, int(rng.integers(20, 200)), bw) for _ in range(6)]


@pytest.mark.parametrize("kind", ["32", "64", "128", "1022", "short",
                                  "window", "short-pad"])
def test_pedit_kernel_matches_plain(kind, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    pk = PE.pack_jobs(_pedit_jobs(kind), cuda_device)
    before = _cuda.pedit_launches
    k0, k1 = _cuda.pedit_rows(pk)
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    assert _cuda.pedit_launches == before + 1
    assert torch.equal(k0, p0) and torch.equal(k1, p1)


def test_pedit_kernel_refuses_wide_band_and_cpu(cuda_device):
    """A band past the register rows' 1,022 cells (bw 1,024) runs the block
    row and equals the plain version; CPU tensors are refused."""
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    from .test_torch_pedit import _mk_job
    rng = np.random.default_rng(2)
    pk = PE.pack_jobs([_mk_job(rng, 40, 1024)], cuda_device)
    k0, k1 = _cuda.pedit_rows(pk)
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    assert torch.equal(k0, p0) and torch.equal(k1, p1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.pedit_rows(PE.pack_jobs([_mk_job(rng, 40, 32)], "cpu"))


# the pedit rows past 1,022 cells (the block row) against the plain
# version, into buffers of 0xA5, jobs with mbeg > 0 and mend < mlen
@pytest.mark.parametrize("bw", [1024, 2046])
def test_pedit_wide_kernel_matches_plain(bw, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    from .test_torch_pedit import _mk_job
    rng = np.random.default_rng(200 + bw)
    jobs = [_mk_job(rng, int(rng.integers(20, 90)), bw) for _ in range(3)]
    jobs[0].mbeg = max(jobs[0].mbeg, 2)
    jobs[0].mend = max(jobs[0].mbeg + 1, min(jobs[0].mend, jobs[0].mlen - 3))
    pk = PE.pack_jobs(jobs, cuda_device)
    out = tuple(torch.full((pk.total,), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(2))
    before = _cuda.pedit_launches
    k0, k1 = _cuda.pedit_rows(pk, out=out)
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    assert _cuda.pedit_launches == before + 1
    assert torch.equal(k0, p0) and torch.equal(k1, p1)


# the pedit block row at poa -G editbw=4096's band (bw 4,094: 16 warps of 8
# cells) and at the widest band (32,510: 32 warps of 32 cells, operands per
# step) into buffers of 0xA5, jobs with mbeg > 0 and mend < mlen; and either
# row forced where both exist (bw 128 and 1,022)
@pytest.mark.parametrize("bw,design", [(4094, None), (32510, None),
                                       (128, "register"), (128, "block"),
                                       (1022, "register"), (1022, "block")])
def test_pedit_block_row_matches_plain(bw, design, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    from .test_torch_pedit import _mk_job
    rng = np.random.default_rng(300 + bw)
    jobs = [_mk_job(rng, int(rng.integers(20, 120)), bw) for _ in range(3)]
    for j in jobs[:2]:
        j.mbeg = max(j.mbeg, 2)
        j.mend = max(j.mbeg + 1, min(j.mend, j.mlen - 3))
    pk = PE.pack_jobs(jobs, cuda_device)
    out = tuple(torch.full((pk.total,), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(2))
    before = _cuda.pedit_block_launches
    k0, k1 = _cuda.pedit_rows(pk, out=out, design=design)
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    blk = design == "block" or (design is None and bw > _cuda.PEDIT_REG_BW)
    assert _cuda.pedit_block_launches == before + blk
    assert torch.equal(k0, p0) and torch.equal(k1, p1)


# every K boundary of the pedit kernel's cells per lane (1, 2, 4, 32)
@pytest.mark.parametrize("bw", [2, 30, 32, 34, 64, 96, 1022])
def test_pedit_kernel_writes_every_byte(bw, cuda_device):
    """Jobs with mbeg > 0 and mend < mlen, the kernel writing into buffers
    filled with 0xA5: the whole matrices equal the plain version's, so the
    kernel writes the zero rows outside [2*mbeg, 2*mend) itself."""
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    from .test_torch_pedit import _mk_job
    rng = np.random.default_rng(100 + bw)
    wide = bw > 500
    jobs = [_mk_job(rng, int(rng.integers(20, 80 if wide else 200)), bw)
            for _ in range(3 if wide else 6)]
    for j in jobs:
        j.mbeg = max(j.mbeg, 2)
        j.mend = max(j.mbeg + 1, min(j.mend, j.mlen - 3))
    pk = PE.pack_jobs(jobs, cuda_device)
    out = tuple(torch.full((pk.total,), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(2))
    k0, k1 = _cuda.pedit_rows(pk, out=out)
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    assert torch.equal(k0, p0) and torch.equal(k1, p1)


# every K of the edit kernel near its boundaries and the widest band, in
# each mode, with banded trajectories (odd rbeg % 32, rows with movx > 0)
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
@pytest.mark.parametrize("nw", [1, 2, 3, 32, 33, 64, 65, 512])
def test_edit_kernel_band_widths(nw, mode, cuda_device):
    rng = np.random.default_rng(7 * nw + mode)
    bw = 32 * nw
    tl = 120 if nw == 512 else 300
    qs = [rng.integers(0, 4, 3 * bw + 40 + 17 * k).astype(np.uint8)
          for k in range(2)]
    ts = [rng.integers(0, 4, tl - 11 * k).astype(np.uint8) for k in range(2)]
    g, ops = _edit_operands(qs, ts, mode, bw, True, cuda_device)
    live = torch.arange(g.T, device=cuda_device).view(-1, 1) < ops.tlen
    assert int(ops.movxs[live].max()) > 0
    assert bool((ops.rbegs[live] % 2 == 1).any())
    _assert_edit_same(g, ops)


# bands past 512 words against the plain version, with banded trajectories
# (rows with movx > 0): the row the main path takes (the block row to NW
# 4,096, the cluster row past it) and the cluster row forced in its default
# geometry, at NW 1,024 also in the sweep (2 pieces a thread, its state
# rows in device memory)
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
@pytest.mark.parametrize("nw", [513, 640, 1024, 4097, 4192, 8192])
def test_edit_cluster_kernel_matches_plain(nw, mode, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(11 * nw + mode)
    bw = 32 * nw
    qs = [rng.integers(0, 4, bw + 700 + 17 * k).astype(np.uint8)
          for k in range(2)]
    ts = [rng.integers(0, 4, 150 - 11 * k).astype(np.uint8) for k in range(2)]
    g, ops = _edit_operands(qs, ts, mode, bw, True, cuda_device)
    live = torch.arange(g.T, device=cuda_device).view(-1, 1) < ops.tlen
    if mode != MODE_OVERLAP:
        assert int(ops.movxs[live].max()) > 0
    counts = (_cuda.edit_block_launches, _cuda.edit_cluster_launches)
    _assert_edit_same(g, ops)
    blk = nw <= _cuda.EDIT_BLOCK_MAX_NW
    assert (_cuda.edit_block_launches - counts[0],
            _cuda.edit_cluster_launches - counts[1]) == (blk, not blk)
    _assert_edit_same(g, ops, design="cluster")
    if nw == 1024:
        _assert_edit_same(g, ops, design="cluster", geometry=(8, 1, 2, 2))


# the block row at each boundary of its geometry (the warp count changes
# past NW 640, 2,048 is 16 warps of 4 words, 2,049 the first of 8 words,
# 4,096 the last the block row takes) and the cluster row past it (4,097),
# global with a banded trajectory; queries past 64 kb read their Eq planes
# from device memory
@pytest.mark.parametrize("nw", [640, 641, 2048, 2049, 4096, 4097])
def test_edit_block_row_geometry_boundaries(nw, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(5 * nw)
    bw = 32 * nw
    qs = [rng.integers(0, 4, bw + 700 + 17 * k).astype(np.uint8)
          for k in range(2)]
    ts = [rng.integers(0, 4, 100 - 11 * k).astype(np.uint8) for k in range(2)]
    g, ops = _edit_operands(qs, ts, MODE_GLOBAL, bw, True, cuda_device)
    geo = _cuda.edit_block_geometry(nw)
    assert (geo is None) == (nw > _cuda.EDIT_BLOCK_MAX_NW)
    counts = (_cuda.edit_block_launches, _cuda.edit_cluster_launches)
    _assert_edit_same(g, ops)
    assert (_cuda.edit_block_launches - counts[0],
            _cuda.edit_cluster_launches - counts[1]) == ((0, 1) if geo is None
                                                         else (1, 0))
    if geo is not None:
        assert 32 * geo[0] * geo[1] >= nw and geo[1] <= _cuda.EDIT_BLOCK_MAXW
        _assert_edit_same(g, ops, design="cluster")


# the block row at edit -W 0's band on 24 kb reads (NW 752, 6 warps) in
# every mode: full band, query longer than the band in overlap
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
def test_edit_block_row_nw752_matches_plain(mode, cuda_device):
    rng = np.random.default_rng(752 + mode)
    L = 24000 if mode != MODE_OVERLAP else 30000
    qs = [rng.integers(0, 4, L - 13 * k).astype(np.uint8) for k in range(3)]
    ts = [q[4000:4600 + 11 * k].copy() for k, q in enumerate(qs)]
    g, ops = _edit_operands(qs, ts, mode, 32 * 752, False, cuda_device)
    _assert_edit_same(g, ops)


# design= forces any row where it exists: register, block and cluster at
# NW 64 (a cluster of one block) and 512, each equal to the plain version
@pytest.mark.parametrize("design", ["register", "block", "cluster"])
@pytest.mark.parametrize("nw", [64, 512])
def test_edit_design_forced_matches_plain(nw, design, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(nw)
    qs = [rng.integers(0, 4, 32 * nw - 40 + 9 * k).astype(np.uint8)
          for k in range(3)]
    ts = [q[: 200 + 13 * k].copy() for k, q in enumerate(qs)]
    g, ops = _edit_operands(qs, ts, MODE_EXTEND, 32 * nw, False, cuda_device)
    _assert_edit_same(g, ops, design=design)
    with pytest.raises(ValueError, match="no 'register' row"):
        _cuda.edit_rows(g._replace(NW=513), ops, design="register")


# the edit block row in a geometry forced: 12 warps of 4 words and 6 or 7
# of 8 at NW 1,536; geometries short of the band, of another K or past the
# warp limit are refused
@pytest.mark.parametrize("geo", [(4, 12), (8, 6), (8, 7)])
def test_edit_block_row_geometry_forced_matches_plain(geo, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    nw = 1536
    rng = np.random.default_rng(geo[0] * geo[1])
    qs = [rng.integers(0, 4, 32 * nw - 50 + 9 * k).astype(np.uint8)
          for k in range(2)]
    ts = [q[3000:3300 + 13 * k].copy() for k, q in enumerate(qs)]
    g, ops = _edit_operands(qs, ts, MODE_OVERLAP, 32 * nw, False, cuda_device)
    _assert_edit_same(g, ops, design="block", geometry=geo)
    for bad in ((4, 11), (16, 3), (8, _cuda.EDIT_BLOCK_MAXW + 1)):
        with pytest.raises(ValueError, match="no 'block' row"):
            _cuda.edit_rows(g, ops, design="block", geometry=bad)


# the edit cluster row in a geometry forced at NW 4,192: 2 blocks of 9 warps
# of 8 words, 3 of 11 of 4, 7 of 5 of 4, the sweep (2 blocks of 5 warps of
# 2 pieces of 8 words); geometries short of the band, with an idle block,
# of another K or past the limits are refused
@pytest.mark.parametrize("geo", [(8, 9, 2), (4, 11, 3), (4, 5, 7),
                                 (8, 5, 2, 2)])
def test_edit_cluster_geometry_forced_matches_plain(geo, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    nw = 4192
    rng = np.random.default_rng(sum(geo))
    qs = [rng.integers(0, 4, 32 * nw - 50 + 9 * k).astype(np.uint8)
          for k in range(2)]
    ts = [q[3000:3200 + 13 * k].copy() for k, q in enumerate(qs)]
    g, ops = _edit_operands(qs, ts, MODE_EXTEND, 32 * nw, False, cuda_device)
    _assert_edit_same(g, ops, design="cluster", geometry=geo)
    for bad in ((8, 9, 1), (4, 9, 8), (16, 9, 2), (8, 17, 1),
                (4, 5, 4, 2), (8, 9, 2, 2)):
        with pytest.raises(ValueError, match="no 'cluster' row"):
            _cuda.edit_rows(g, ops, design="cluster", geometry=bad)


# past the cluster's registers (NW 65,537: the sweep at the portable size,
# or 16 blocks where the card takes them), banded with rows that shift,
# and the sweep forced against the registers at NW 32,768; few rows
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_EXTEND])
def test_edit_cluster_sweep_matches_plain(mode, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(65537 + mode)
    nw = 65537
    qs = [rng.integers(0, 4, 32 * nw + 900).astype(np.uint8)]
    ts = [rng.integers(0, 4, 40).astype(np.uint8)]
    g, ops = _edit_operands(qs, ts, mode, 32 * nw, True, cuda_device)
    before = _cuda.edit_cluster_launches
    _assert_edit_same(g, ops)
    assert _cuda.edit_cluster_launches == before + 1
    nw = 32768
    qs = [rng.integers(0, 4, 32 * nw - 100).astype(np.uint8)]
    ts = [qs[0][5000:5040].copy()]
    g, ops = _edit_operands(qs, ts, mode, 32 * nw, False, cuda_device)
    _assert_edit_same(g, ops, design="cluster", geometry=(8, 8, 8, 2))


def test_edit_cluster_occupancy_and_floor(cuda_device):
    """The cluster sizes the card takes (2 to 8 always; 16 where the card
    takes that non-portable size, which edit_cluster_max reports) and the
    exchange's probe, which runs every row."""
    from bsalign_tpu_torch.ops import _cuda
    for C in (2, 4, 8):
        assert _cuda.edit_cluster_occupancy(8, 16, C) > 0
        out = _cuda.edit_cluster_floor(C, 2, 3, 100, cuda_device)
        assert out.tolist() == [100] * (3 * C)
    n16 = _cuda.edit_cluster_occupancy(8, 16, 16)
    assert _cuda.edit_cluster_max(cuda_device) == (16 if n16 > 0 else 8)


# the pedit block row in every geometry it can take at bw 4,094 (4 to 32
# cells a thread, the least warps for each) into buffers of 0xA5; geometries
# short of the band, with idle cells or past the warp limit are refused
@pytest.mark.parametrize("K", [4, 8, 16, 32])
def test_pedit_block_row_geometries_match_plain(K, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import pedit as PE
    from .test_torch_pedit import _mk_job
    bw = 4094
    rng = np.random.default_rng(400 + K)
    jobs = [_mk_job(rng, int(rng.integers(20, 120)), bw) for _ in range(3)]
    jobs[0].mbeg = max(jobs[0].mbeg, 2)
    pk = PE.pack_jobs(jobs, cuda_device)
    out = tuple(torch.full((pk.total,), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(2))
    k0, k1 = _cuda.pedit_rows(pk, out=out, design="block",
                              geometry=(K, -(-bw // (32 * K))))
    p0, p1 = PE.forward_plain(pk)
    torch.cuda.synchronize()
    assert torch.equal(k0, p0) and torch.equal(k1, p1)
    for bad in ((4, 31), (32, 8), (2, _cuda.PEDIT_BLOCK_MAXW + 1)):
        with pytest.raises(ValueError, match="no block row"):
            _cuda.pedit_rows(pk, design="block", geometry=bad)


# kernel A with its planes in device memory against the shared store, in
# every emit, at W 1, 3, 9 and 128 (the last resumed in chunks too)
STORE_CASES = [(1, MODE_GLOBAL), (3, MODE_OVERLAP), (9, MODE_EXTEND),
               (128, MODE_OVERLAP)]


@pytest.mark.parametrize("emit", ["codes", "planes", "none"])
@pytest.mark.parametrize("case", range(len(STORE_CASES)))
def test_kernel_global_store_matches_shared(case, emit, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    W, mode = STORE_CASES[case]
    gaps = {"codes": AFFINE, "planes": SHORT_TWO_PIECE, "none": LINEAR}[emit]
    lens = (2400, 2600, 2100) if W == 128 else (150, 230, 300)
    qs, ts = _pairs(lens, 0.12, 90 + case)
    qs[-1] = qs[-1][:37]
    pw, T, args = _operands(qs, ts, mode, gaps, W)
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, emit)
    st = K.state_from_numpy(*args, T=T, device=cuda_device)
    shared = _cuda.banded8_rows(g, st, store="shared")
    _assert_same(_cuda.banded8_rows(g, st, store="global"), shared)
    if W != 128:
        return
    (qpad, qlens, tpad, tlens, mtx5, rby), state = args[:6], list(args[6:])
    reg, parts = None, []
    for c0 in range(0, T, 1024):
        n = min(1024, T - c0)
        stc = K.state_from_numpy(qpad, qlens, tpad[:, c0:c0 + n], tlens,
                                 mtx5, rby[c0:c0 + n], *state, reg, c0, T=n,
                                 device=cuda_device)
        r = _cuda.banded8_rows(g._replace(T=n), stc, store="global")
        parts.append(r)
        state = (r["fin_planes"] + [None, None])[:3] + [r["fin_ub"]]
        reg = r["fin_reg"]
    torch.cuda.synchronize()
    joined = {k: (r[k] if k.startswith("fin") or r[k] is None
                  else torch.cat([p[k] for p in parts], 0)) for k in r}
    _assert_same(joined, shared)


def test_edit_kernel_long_query_reads_device_memory(cuda_device):
    """A query past 131,072 bases: its Eq planes (more than 64 KB) are read
    from device memory instead of a shared-memory copy."""
    rng = np.random.default_rng(77)
    qs = [rng.integers(0, 4, 140000).astype(np.uint8)]
    ts = [rng.integers(0, 4, 200).astype(np.uint8)]
    g, ops = _edit_operands(qs, ts, MODE_GLOBAL, 64, True, cuda_device)
    assert 16 * ops.qeq.shape[2] > 64 * 1024
    _assert_edit_same(g, ops)


def test_run_windows_cuda_matches_cpu(cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.poa import batch as PB
    from bsalign_tpu_torch.poa.core import BSPOAPar
    from .test_torch_pedit import _gen_window
    rng = np.random.default_rng(12)
    wins = [_gen_window(rng, 10, 300 + 50 * k) for k in range(2)]
    before = _cuda.pedit_launches
    gpu = PB.run_windows(wins, BSPOAPar(), device=cuda_device, want_msa=True)
    # one launch per realignment round, all windows in it
    assert _cuda.pedit_launches - before == BSPOAPar().realn
    cpu = PB.run_windows(wins, BSPOAPar(), device="cpu", want_msa=True)
    for a, b in zip(gpu, cpu):
        assert np.array_equal(a.cns, b.cns)
        assert np.array_equal(a.qlt, b.qlt)
        assert np.array_equal(a.alt, b.alt)
        assert a.snvs == b.snvs and a.msa == b.msa


def test_cat_cuda_matches_cpu(cuda_device, tmp_path):
    """`cat` on the card and on the CPU print the same bytes, one banded-8
    launch per join at least (a retry and a 6 N join among them)."""
    import contextlib
    import io
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(81)
    ref = rng.integers(0, 4, 900)
    spans = [(0, 300), (200, 500), (400, 700), (760, 900)]
    text = "".join(f">w{k}{' overlap=50' if k == 1 else ''}\n"
                   + "".join("ACGT"[b] for b in ref[lo:hi]) + "\n"
                   for k, (lo, hi) in enumerate(spans))
    fa = tmp_path / "w.fa"
    fa.write_text(text)
    outs = []
    for d in ("cuda", "cpu"):
        before = _cuda.launches_codes
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert CLI.main(["cat", "--device", d, "-W", "100",
                             str(fa)]) == 0
        outs.append(buf.getvalue())
        if d == "cuda":
            assert _cuda.launches_codes - before >= len(spans) - 1
    assert outs[0] == outs[1] and "NNNNNN" in outs[0]


def test_sharded_forwards_on_one_card(cuda_device):
    """The batch split over [cuda:0] * 2 (an odd batch) against the
    unsplit launch: kernel A codes, B (rows below tlen), C."""
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.ops import edit as KE
    from bsalign_tpu_torch.ops import pedit as PE
    from bsalign_tpu_torch.parallel import mesh as M
    from bsalign_tpu_torch.poa.core import BSPOA, BSPOAPar
    qs, ts = _pairs((90, 160, 220, 130, 200), 0.12, 21)
    pw, T, args = _operands(qs, ts, MODE_GLOBAL, AFFINE, 2)
    geo = (T, 2, MODE_GLOBAL, pw, *AFFINE, NT_MAX, NT_MIN)
    mesh = [cuda_device] * 2
    got = M.make_sharded_forward(*geo, mesh, codes=True)(*args)
    want = K.make_forward(*geo, codes=True, device=cuda_device)(*args)
    for a, b in zip(got, want):
        for x, y in (zip(a, b) if isinstance(a, (list, tuple))
                     else [(a, b)]):
            assert (x is None and y is None) or torch.equal(x, y)
    Te, NWQ, ops = D._pack_bucket(qs, ts, 256, False)
    ge = M.make_sharded_edit_forward(Te, 8, MODE_GLOBAL, NWQ, False,
                                     mesh)(*ops)
    we = KE.make_edit_forward(Te, 8, MODE_GLOBAL, NWQ, False,
                              device=cuda_device)(*ops)
    for j, tl in enumerate(ops[3]):
        for f in ("pm", "pp", "sbeg"):
            assert np.array_equal(getattr(ge, f)[:tl, ..., j],
                                  getattr(we, f)[:tl, ..., j])
    for f in ("smin", "ry", "final_score", "final_sbeg"):
        assert np.array_equal(getattr(ge, f), getattr(we, f))
    rng = np.random.default_rng(22)
    jobs = []
    for _ in range(3):
        r = rng.integers(0, 4, 200)
        g = BSPOA(BSPOAPar(), device="cpu")
        g.beg()
        for _ in range(5):
            keep = rng.random(200) > 0.08
            g.push("".join("ACGT"[b] for b in r[keep]))
        assert g.end_begin()
        g.msa()
        g.cns_call()
        jobs += g._remsa_dev_build(g._remsa_prepare(g.par.editbw // 2, 1),
                                   1)[0]
    gp = M.sharded_pedit_forward(jobs, [cuda_device] * 3)
    wp = PE.pedit_forward_batch(jobs, device=cuda_device)
    assert len(gp) == len(wp) == len(jobs)
    for (a0, a1), (b0, b1) in zip(gp, wp):
        assert np.array_equal(a0, b0) and np.array_equal(a1, b1)
    M.dryrun_multichip(torch.cuda.device_count())


# ---- kernel A's wide row (csrc/banded8_wide.cu) against the narrow row ----

WIDE_COMBOS = [(pw, emit) for pw in (0, 1, 2)
               for emit in ("codes", "planes", "none")
               if not (emit == "codes" and pw == 2)]
WIDE_GAPS = {0: LINEAR, 1: AFFINE, 2: TWO_PIECE}


def _wide_state(W, pw, emit, mode, seed, device, T=128, n=3):
    """n pairs of about 1.1 bands (the last short, frozen early), cut to
    T rows, at band 16 W."""
    L = int(16 * W * 1.1) + 64
    qs, ts = _pairs((L,) * n, 0.10, seed)
    qs[-1], ts[-1] = qs[-1][:L // 2], ts[-1][:min(L // 3, T // 2)]
    gaps = WIDE_GAPS[pw]
    pw_, T0, args = _operands(qs, ts, mode, gaps, W)
    assert pw_ == pw
    T = min(T, T0)
    qpad, qlens, tpad, tlens, mtx5, rby = args[:6]
    g = K.Geometry(T, W, mode, pw, *gaps, NT_MAX, NT_MIN, emit)
    st = K.state_from_numpy(qpad, qlens, tpad[:, :T], tlens, mtx5, rby[:T],
                            *args[6:], T=T, device=device)
    return g, st


def _wide_and_narrow(g, st, **kw):
    from bsalign_tpu_torch.ops import _cuda
    rw = _cuda.banded8_rows(g, st, design="wide", count_replays=True, **kw)
    rn = _cuda.banded8_rows(g, st, design="narrow", **kw)
    torch.cuda.synchronize()
    return rw, rn


@pytest.mark.parametrize("W", ["WIDE_W", 64, 128, 1504, 2000])
@pytest.mark.parametrize("mode", [MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND])
@pytest.mark.parametrize("combo", range(len(WIDE_COMBOS)))
def test_wide_row_matches_narrow(combo, mode, W, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    W = _cuda.WIDE_W if W == "WIDE_W" else W
    pw, emit = WIDE_COMBOS[combo]
    g, st = _wide_state(W, pw, emit, mode, 300 + W + combo, cuda_device)
    rw, rn = _wide_and_narrow(g, st)
    rw.pop("replays")
    _assert_same(rw, rn)


@pytest.mark.parametrize("store", ["shared", "global"])
@pytest.mark.parametrize("combo", range(len(WIDE_COMBOS)))
def test_wide_row_resumed_odd_batch_and_stores(combo, store, cuda_device):
    """The wide row resumed in chunks of 48 rows (a short last chunk) with
    each store, on an odd batch whose pairs freeze at different rows,
    gives the narrow row's one-shot launch."""
    from bsalign_tpu_torch.ops import _cuda
    pw, emit = WIDE_COMBOS[combo]
    g, st = _wide_state(40, pw, emit, MODE_GLOBAL, 400 + combo, cuda_device,
                        T=250, n=5)
    one = _cuda.banded8_rows(g, st, design="narrow")
    reg, state, parts = None, [st.us, st.es, st.qs, st.ub], []
    for c0 in range(0, g.T, 48):
        n = min(48, g.T - c0)
        r = _cuda.banded8_rows(g._replace(T=n), st._replace(
            tseq=st.tseq[:, c0:c0 + n].contiguous(),
            rby=st.rby[c0:c0 + n].contiguous(), us=state[0], es=state[1],
            qs=state[2], ub=state[3], reg=st.reg if reg is None else reg,
            row0=c0), design="wide", store=store)
        parts.append(r)
        state = (r["fin_planes"] + [None, None])[:3] + [r["fin_ub"]]
        reg = r["fin_reg"]
    torch.cuda.synchronize()
    last = parts[-1]
    joined = {k: (last[k] if k.startswith("fin") or last[k] is None
                  else torch.cat([p[k] for p in parts], 0)) for k in last}
    _assert_same(joined, one)


@pytest.mark.parametrize("gaps", [AFFINE, LINEAR, (-4, -2, -10, -1)])
def test_wide_row_full_band_reset_matches_plain(gaps, cuda_device):
    """qlen >> tlen: the global steering moves the band past its width
    (a full reset) in the wide row at band 32 (W = 2)."""
    from bsalign_tpu_torch.ops import _cuda
    rng = np.random.default_rng(22)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (1600, 1800, 1400)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
    pw, T, args = _operands(qs, ts, MODE_GLOBAL, gaps, 2)
    g = K.Geometry(T, 2, MODE_GLOBAL, pw, *gaps, NT_MAX, NT_MIN,
                   "planes" if pw == 2 else "codes")
    st = K.state_from_numpy(*args, T=T, device=cuda_device)
    rw = _cuda.banded8_rows(g, st, design="wide")
    rp = K.forward_plain(g, st)
    torch.cuda.synchronize()
    begs = rw["begs"].cpu().numpy()
    assert max(np.diff(begs[:40, b], prepend=0).max() for b in range(3)) >= 32
    _assert_same(rw, rp)


@pytest.mark.parametrize("W", [32, 40])
@pytest.mark.parametrize("combo", range(len(WIDE_COMBOS)))
def test_wide_row_matches_plain(combo, W, cuda_device):
    from bsalign_tpu_torch.ops import _cuda
    pw, emit = WIDE_COMBOS[combo]
    mode = (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND)[combo % 3]
    g, st = _wide_state(W, pw, emit, mode, 500 + W + combo, cuda_device,
                        T=160)
    rw = _cuda.banded8_rows(g, st, design="wide")
    rp = K.forward_plain(g, st)
    torch.cuda.synchronize()
    _assert_same(rw, rp)


@pytest.mark.parametrize("combo", range(len(WIDE_COMBOS)))
def test_wide_row_replays_adversarial_state(combo, cuda_device):
    """Random planes that drive f and g to the clamp at 127: the scan's
    proposals fail the boundary check, the rows replay in the kernel, and
    every output still equals the narrow row's and the plain version's."""
    pw, emit = WIDE_COMBOS[combo]
    g, st = _wide_state(40, pw, emit, MODE_OVERLAP, 600 + combo, cuda_device,
                        T=40)
    rng = np.random.default_rng(600 + combo)
    shp = tuple(st.us.shape)

    def rnd(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, shp).astype(np.int32),
                               device=cuda_device)
    st = st._replace(us=rnd(-128, -60), es=rnd(20, 128) if pw >= 1 else None,
                     qs=rnd(20, 128) if pw == 2 else None)
    rw, rn = _wide_and_narrow(g, st)
    replays = rw.pop("replays")
    assert int(replays.sum()) > 0
    _assert_same(rw, rn)
    _assert_same(rw, K.forward_plain(g, st))


def test_wide_row_dispatch_and_counts(cuda_device):
    """banded8_rows takes the wide row from WIDE_W stripes on and counts
    its launches apart from the narrow row's; the replay counter is the
    wide row's alone."""
    from bsalign_tpu_torch.ops import _cuda
    for W, wide in ((_cuda.WIDE_W - 1, False), (_cuda.WIDE_W, True)):
        g, st = _wide_state(W, 1, "codes", MODE_OVERLAP, 700 + W, cuda_device,
                            T=32)
        n0, w0 = _cuda.launches_codes, _cuda.launches_wide_codes
        _cuda.banded8_rows(g, st)
        assert (_cuda.launches_codes - n0, _cuda.launches_wide_codes - w0) \
            == ((0, 1) if wide else (1, 0))
    with pytest.raises(ValueError):
        _cuda.banded8_rows(g, st, design="narrow", count_replays=True)
