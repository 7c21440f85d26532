"""The port's poa/extras against bsalign_tpu's, on the CPU.

Each case of tests/test_poa_extras.py runs on both packages with the same
reads (made from a seed with numpy): subset, clip and the read regions,
the DOT and FASTA dumps, the LSP windows and their scores, the LSP re-POA
and the MSA merge. MSA columns, consensus, dumps and scores must be equal
(tolerance 0: integer codes and text; the LSP scores are the same sums of
the same doubles in the same order). The port's POAs run with
device="cpu", so their realignment rounds take the pedit kernel's plain
version.
"""
import copy
import io

import numpy as np
import pytest
import torch

from bsalign_tpu.poa import cli as JCLI
from bsalign_tpu.poa import core as JC
from bsalign_tpu.poa import extras as JX
from bsalign_tpu_torch.poa import cli as TCLI
from bsalign_tpu_torch.poa import core as TC
from bsalign_tpu_torch.poa import extras as TX

torch.set_num_threads(1)

BASES = "ACGT"


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    monkeypatch.delenv("BSA_PEDIT_DEVICE", raising=False)


def _reads(seed, n, reflen, err, mix=(0.3, 0.6)):
    """n reads of one seeded reference at `err` (substitutions below
    mix[0] * err, insertions below mix[1] * err, else deletions)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, reflen).astype(np.uint8)
    out = []
    for _ in range(n):
        s, i = [], 0
        while i < len(ref):
            r = rng.random()
            if r < err * mix[0]:
                s.append((int(ref[i]) + int(rng.integers(1, 4))) & 3)
                i += 1
            elif r < err * mix[1]:
                s.append(int(rng.integers(0, 4)))
            elif r < err:
                i += 1
            else:
                s.append(int(ref[i]))
                i += 1
        out.append("".join(BASES[c] for c in s))
    return out


def _poa(pkg, reads):
    if pkg == "jax":
        g = JC.BSPOA(JCLI.default_poa_par())
    else:
        g = TC.BSPOA(TCLI.default_poa_par(), device="cpu")
    g.beg()
    for s in reads:
        g.push(s)
    g.end()
    return g


def _msa(g):
    """The MSA in display order, the consensus, qlt and alt."""
    order = np.asarray(g.msaidxs, np.int64)
    return (np.asarray(g.msacols)[order].tobytes(), bytes(g.cns),
            bytes(g.qlt), bytes(g.alt))


def _dump(fn, *args):
    buf = io.StringIO()
    fn(*args, buf)
    return buf.getvalue()


READS10 = _reads(5, 10, 300, 0.12)


def test_rdregs_subset_clip_and_dumps():
    jg, tg = _poa("jax", READS10), _poa("torch", READS10)
    assert _msa(jg) == _msa(tg)
    assert JX.calc_msa_rdregs(jg) == TX.calc_msa_rdregs(tg)
    assert JX.calc_cns_rdregs(jg) == TX.calc_cns_rdregs(tg)
    keep = [True, False, True, False, True, True, False, True, False, True]
    jd, td = JX.subset(jg, keep), TX.subset(tg, keep)
    assert td.nrds == jd.nrds == 6 and len(td.cns) > 0
    assert _msa(jd) == _msa(td)
    for fn in ("print_dot", "print_vstdot", "print_seqs"):
        got = _dump(getattr(TX, fn), tg)
        assert got == _dump(getattr(JX, fn), jg), fn
    assert got.count(">S") == len(tg.seqs)
    for node in (tg.g.rdnode(0, 10), tg.g.rdnode(3, 50)):
        j = io.StringIO()
        JX.print_local_dot(jg, j, node)
        t = io.StringIO()
        TX.print_local_dot(tg, t, node)
        assert t.getvalue() == j.getvalue() and "->" in t.getvalue()
    jc, tc = _poa("jax", READS10), _poa("torch", READS10)
    JX.clip_reads_msa(jc, 5, 5)
    TX.clip_reads_msa(tc, 5, 5)
    assert _msa(jc) == _msa(tc)
    assert int((np.asarray(tc.msacols)[:, :10] == 5).sum()) > 0


def test_lsps_and_remsa_lsps():
    """The LSP windows of a finished POA (rid, spans, scores), then the
    re-POA of every window in place: same MSA and consensus after it."""
    jg, tg = _poa("jax", READS10), _poa("torch", READS10)
    JX.add_cnsnodes(jg)
    TX.add_cnsnodes(tg)
    jl = JX.gen_lsps(jg, jg.par)
    tl = TX.gen_lsps(tg, tg.par)
    key = lambda ls: [(x.rid, x.rbeg, x.rlen, x.mbeg, x.mlen, x.scr)  # noqa
                      for x in ls]
    assert key(tl) == key(jl) and tl
    JX.del_cnsnodes(jg)
    TX.del_cnsnodes(tg)
    assert len(tg.g.nodes) == len(jg.g.nodes)
    jn = JX.remsa_lsps(jg, jg.par)
    tn = TX.remsa_lsps(tg, tg.par)
    assert tn == jn > 0
    assert _msa(jg) == _msa(tg) and len(tg.cns) > 250
    jg.tidy_msa()
    tg.tidy_msa()
    jg.call_snvs()
    tg.call_snvs()
    assert _msa(jg) == _msa(tg)


def test_lsp_score_high_event_states():
    """_cal_rd_lsp_score over whole reads of an indel-rich POA (the walk
    reaches table indices past 255) equals the JAX package's."""
    reads = _reads(11, 8, 240, 0.18, mix=(0.25, 0.55))
    jg, tg = _poa("jax", reads), _poa("torch", reads)
    mlen = len(tg.msaidxs)
    for rid in range(tg.nrds):
        assert TX._cal_rd_lsp_score(tg, TX.Lsp(rid, 0, 0, 0, 0, mlen)) == \
            JX._cal_rd_lsp_score(jg, JX.Lsp(rid, 0, 0, 0, 0, mlen))


def _mat(g):
    mlen = len(g.msaidxs)
    mat = np.zeros((mlen, g.nrds + 3), np.uint8)
    for p in range(mlen):
        mat[p] = g.msacols[g.msaidxs[p]]
    return mat, g.nrds


def test_merge_msas():
    """Two finished MSAs of one locus merged into one POA: the JAX
    package's MSAs (from its own POAs) go into both packages' merge."""
    reads = _reads(7, 10, 300, 0.10)
    m1 = _mat(_poa("jax", reads[:5]))
    m2 = _mat(_poa("jax", reads[5:]))
    assert _mat(_poa("torch", reads[:5]))[0].tobytes() == m1[0].tobytes()
    jd = JX.merge_msas(JCLI.default_poa_par(), [m1, m2])
    td = TX.merge_msas(TCLI.default_poa_par(), [copy.deepcopy(m1),
                                                copy.deepcopy(m2)],
                       device="cpu")
    assert td.nrds == jd.nrds >= 10 and len(td.cns) > 250
    assert _msa(jd) == _msa(td)


def test_graph_edges_connect_and_disconnect():
    """get_edge, edges[], connect_rdnode and disconnect_rdnode of the
    port's graph (native bsa_g_connect / bsa_g_disconnect) leave the same
    edges as the JAX package's graph."""
    jg, tg = _poa("jax", READS10[:4]), _poa("torch", READS10[:4])

    def edge(gr, rid, pos):
        e = gr.get_edge(gr.rdnode(rid, pos - 1), gr.rdnode(rid, pos))
        return e, (gr.edges[e].cov if e else 0)
    for gr in (jg.g, tg.g):
        gr.disconnect_rdnode(2, 30)
        gr.disconnect_rdnode(3, 31)
    assert edge(tg.g, 2, 30) == edge(jg.g, 2, 30)
    assert edge(tg.g, 3, 31) == edge(jg.g, 3, 31)
    for gr in (jg.g, tg.g):
        gr.connect_rdnode(2, 30)
    assert edge(tg.g, 2, 30) == edge(jg.g, 2, 30) and edge(tg.g, 2, 30)[1]
    assert len(tg.g.edges) == len(jg.g.edges)
    assert _dump(TX.print_dot, tg) == _dump(JX.print_dot, jg)
