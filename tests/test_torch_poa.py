"""The port's `poa` against bsalign_tpu's, on the CPU.

(i) `bsalign_tpu_torch poa --device cpu` against `bsalign_tpu.cli poa` on
the same FASTA, in process: the same bytes on stdout (MSA, consensus,
QLT/ALT and SNV lines) and in the -o file. The JAX side runs its default
host engine (the native remsa round); the port runs every realignment
round through its batched pedit path with the plain forward.
(ii) `run_windows(device="cpu")` on 3 windows against the JAX package's
`run_windows(device=False)`: cns, qlt, alt, SNV lines and MSA text.
(iii) The scalar remsa_edits path (editbw < 0) of the engine against the
JAX engine. Every comparison is exact.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from bsalign_tpu.poa import batch as JB
from bsalign_tpu.poa import cli as JCLI
from bsalign_tpu.poa import core as JC
from bsalign_tpu_torch import cli as TCLI
from bsalign_tpu_torch.poa import batch as TB
from bsalign_tpu_torch.poa import core as TC

from .test_torch_pedit import _gen_window

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    monkeypatch.delenv("BSA_PEDIT_DEVICE", raising=False)


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn() == 0
    return buf.getvalue()


def _fasta(path, reads):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return str(path)


# (case, reads, length, seed, flags)
CLI_CASES = [
    ("defaults", 8, 200, 1, []),
    ("global", 8, 200, 1, ["-m", "global"]),
    ("oneline-color", 8, 160, 2, ["-L", "-C"]),
    ("cns-file", 6, 180, 3, ["-o", "{tmp}/cns.fa"]),
    ("editbw-neg", 4, 50, 4, ["-G", "editbw=-64"]),
    ("rerun", 6, 150, 5, ["-R", "2"]),
    ("refmode", 8, 200, 6, ["-G", "refmode=1"]),
    ("noncore-45", 45, 120, 7, []),
]


@pytest.mark.parametrize("case,n,L,seed,flags", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_cli_matches_jax(tmp_path, case, n, L, seed, flags):
    fa = _fasta(tmp_path / "w.fa",
                _gen_window(np.random.default_rng(seed), n, L))
    outs = []
    for side, run in (("jax", JCLI.run_poa),
                      ("torch", lambda a: TCLI.main(["poa", "--device", "cpu"]
                                                    + a))):
        d = tmp_path / side
        d.mkdir()
        argv = [f.format(tmp=d) for f in flags] + [fa]
        text = _stdout(lambda: run(argv))
        cns = (d / "cns.fa").read_text() if (d / "cns.fa").exists() else None
        outs.append((text, cns))
    assert outs[0] == outs[1]
    assert outs[0][0].count("\n") > 3 or case == "editbw-neg"
    if case == "cns-file":
        assert outs[1][1].startswith(">cns_seq\n")


def test_run_windows_matches_jax():
    rng = np.random.default_rng(11)
    wins = [_gen_window(rng, 6, 140 + 30 * k) for k in range(3)]
    host = JB.run_windows(wins, JC.BSPOAPar(), device=False, want_msa=True)
    port = TB.run_windows(wins, TC.BSPOAPar(), device="cpu", want_msa=True)
    assert len(host) == len(port) == 3
    for h, p in zip(host, port):
        assert np.array_equal(h.cns, p.cns)
        assert np.array_equal(h.qlt, p.qlt)
        assert np.array_equal(h.alt, p.alt)
        assert h.snvs == p.snvs
        assert h.msa == p.msa and len(p.cns) > 100
    probe = TB.last_probe
    assert probe["n_windows"] == 3 and probe["nbatches"] == 3
    assert probe["njobs"] > 0


def test_remsa_edits_matches_jax():
    """editbw < 0 runs the scalar host realignment (refmode, one round)."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 200)
    reads = []
    for _ in range(4):
        q = []
        for b in ref:
            r = rng.random()
            if r < 0.036:
                q.append(int(rng.integers(0, 4)))
            elif r < 0.072:
                q += [int(b), int(rng.integers(0, 4))]
            elif r >= 0.12:
                q.append(int(b))
        reads.append("".join("ACGT"[b] for b in q))
    res = []
    for eng, kw in ((JC.BSPOA, {}), (TC.BSPOA, {"device": "cpu"})):
        par = (JC if eng is JC.BSPOA else TC).BSPOAPar(refmode=1, editbw=-64,
                                                       realn=1)
        g = eng(par, **kw)
        g.beg()
        for s in reads:
            g.push(s)
        g.end()
        g.tidy_msa()
        g.call_snvs()
        order = np.asarray(g.msaidxs, np.int64)
        res.append((bytes(g.cns), bytes(g.qlt), g.msacols[order].tobytes()))
    assert res[0] == res[1] and len(res[0][0]) > 150
