"""The port's multi-process data parallelism (parallel/dist.py), on the CPU.

The single-process functions, as tests/test_dist.py holds the JAX
package's; then `align --dist` and `edit --dist` over two localhost
processes in a gloo process group (parallel/loopback.py): the gathered
output must equal the single-process output and `bsalign_tpu.cli`'s for
the same file, byte for byte. Every subprocess has a timeout.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from bsalign_tpu import cli as JCLI
from bsalign_tpu_torch.parallel import dist, loopback

from .util import gen_pair, write_pairs_fasta

torch.set_num_threads(1)

# the workers' environment: one thread each, as the tests' own process
ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def test_process_shard_single(monkeypatch):
    monkeypatch.delenv("BSA_DIST", raising=False)
    assert not dist.enabled_by_env()
    monkeypatch.setenv("BSA_DIST", "1")
    assert dist.enabled_by_env()
    assert dist.process_info() == (0, 1)
    assert list(dist.process_shard(10)) == list(range(10))


def test_gather_blobs_single_process():
    blobs = [b"alpha", b"", b"gamma" * 100]
    assert dist.gather_blobs(blobs) == [blobs]


def test_distribute_texts_single_process():
    texts = ["a\n", "", "ccc\n"]
    assert dist.distribute_texts(3, texts) == texts


def test_shard_split_covers_all(monkeypatch):
    """process_shard's contiguous split partitions [0, n) exactly."""
    for n in (0, 1, 7, 64):
        for pcnt in (1, 2, 3, 8):
            seen = []
            for pid in range(pcnt):
                monkeypatch.setattr(dist, "process_info",
                                    lambda pid=pid: (pid, pcnt))
                seen.extend(dist.process_shard(n))
            assert seen == list(range(n))


def test_process_device(monkeypatch):
    assert dist.process_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.process_device("cuda") == torch.device("cuda", 1)


def _jax_stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("cmd,flags", [
    ("align", ["-m", "global", "-W", "64"]),
    ("edit", ["-m", "global", "-W", "0"]),
])
def test_two_process_loopback(tmp_path, cmd, flags):
    """5 pairs over 2 processes (shards of 3 and 2)."""
    rng = np.random.default_rng(11)
    fa = str(tmp_path / "pairs.fa")
    write_pairs_fasta(fa, [gen_pair(rng, 160, 0.12) for _ in range(5)])
    single, got, info = loopback.run_loopback(
        fa, cmd=cmd, nprocs=2, device="cpu", flags=flags, timeout=240,
        env=ENV)
    want = _jax_stdout(JCLI.main_align if cmd == "align" else JCLI.main_edit,
                       flags + [fa])
    assert single == got == want and want.count("\n") == 5 * 4
    assert len(info["dist_s"]) == 2
