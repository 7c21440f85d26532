"""The port's io/, seqs and utils/ modules, on the CPU.

The cases of tests/test_io_utils.py, test_io_edges.py and test_seqbank.py
run on the port's modules; pgzf files written by either package are read
by the other, and both packages write the same compressed bytes; the
port's read_fastx reads a pgzf file (through its own io.filereader) and a
plain gzip file of the same records alike, and equal to the JAX
package's records.
"""
import gzip
import io
import os

import numpy as np
import pytest

from bsalign_tpu import seqs as JS
from bsalign_tpu.io import pgzf as JP
from bsalign_tpu_torch import seqs as S
from bsalign_tpu_torch.io.filereader import FileReader, sniff
from bsalign_tpu_torch.io.filewriter import BufferedWriter
from bsalign_tpu_torch.io.pgzf import PgzfReader, PgzfWriter, open_pgzf
from bsalign_tpu_torch.utils import bitvec, objstore
from bsalign_tpu_torch.utils import sort as usort
from bsalign_tpu_torch.utils import sysinfo, workers


def _write_pgzf(path, payload, bufsize, writer=PgzfWriter):
    with writer(path, bufsize=bufsize, ncpu=2) as w:
        w.write(payload)


def test_io_and_utils(tmp_path, monkeypatch):
    """tests/test_io_utils.py on the port's modules (1 MB instead of 3)."""
    rng = np.random.default_rng(0)
    data = rng.integers(65, 91, 1_000_000).astype(np.uint8).tobytes()
    w = PgzfWriter(str(tmp_path / "t.pgz"), bufsize=1 << 18, ncpu=3)
    for i in range(0, len(data), 70001):
        w.write(data[i:i + 70001])
    w.close()
    r = PgzfReader(str(tmp_path / "t.pgz"), ncpu=3)
    assert r.kind == "pgzf" and r.xsize == len(data)
    assert r.read() == data
    r.close()
    assert gzip.open(str(tmp_path / "t.pgz")).read() == data
    with gzip.open(str(tmp_path / "t2.gz"), "wb") as f:
        f.write(data[:100000])
    r = PgzfReader(str(tmp_path / "t2.gz"))
    assert r.kind == "gz" and r.read() == data[:100000]
    r = PgzfReader(str(tmp_path / "t.pgz"))
    r.seek_block(2)
    assert r.read(1 << 18) == data[2 * (1 << 18):3 * (1 << 18)]
    with BufferedWriter(str(tmp_path / "t3.gz")) as bw:
        for i in range(1000):
            bw.write(f"line{i}\tx{i}\n")
    assert sniff(str(tmp_path / "t3.gz")) == "pgzf"
    lines = list(FileReader(str(tmp_path / "t3.gz")))
    assert len(lines) == 1000 and lines[7] == "line7\tx7"
    assert list(FileReader(str(tmp_path / "t3.gz")).tabs())[13] == \
        ["line13", "x13"]
    obj = {"a": np.arange(100, dtype=np.int32), "b": np.ones((3, 4)),
           "tag": "x", "blob": b"hello"}
    objstore.dump_obj_file(obj, str(tmp_path / "t.obj"))
    back = objstore.load_obj_file(str(tmp_path / "t.obj"))
    assert np.array_equal(back["a"], obj["a"]) and back["tag"] == "x" \
        and back["blob"] == b"hello"
    monkeypatch.setattr(objstore, "_REG_DIR", str(tmp_path / "reg"))
    objstore.share_obj("demo", obj)
    att = objstore.attach_obj("demo")
    assert att and np.array_equal(att["b"], obj["b"])
    assert objstore.unshare_obj("demo") and objstore.attach_obj("demo") is None
    bv = bitvec.BitVec(1000)
    idx = sorted(rng.choice(1000, 87, replace=False))
    for i in idx:
        bv.one(int(i))
    bv.index()
    assert bv.rank1(500) == sum(1 for i in idx if i < 500)
    assert bv.select1(10) == idx[10]
    assert bv.count_ones() == 87
    a = rng.integers(0, 1 << 30, 200000)
    assert np.array_equal(usort.psort_array(a, 4), np.sort(a))
    assert usort.quick_median_array([5, 1, 9, 3, 7]) == 5


def test_pgzf_multiblock_roundtrip_and_seek(tmp_path):
    rng = np.random.default_rng(0)
    payload = rng.integers(32, 127, 3 * 65536 + 777).astype(np.uint8) \
        .tobytes()
    p = tmp_path / "m.pgz"
    _write_pgzf(str(p), payload, bufsize=65536)
    with PgzfReader(str(p)) as r:
        assert r.read() == payload
    with PgzfReader(str(p)) as r:
        r.seek_block(2)
        assert r.read(100) == payload[2 * 65536:2 * 65536 + 100]
        r.seek_block(0)
        assert r.read(10) == payload[:10]


def test_pgzf_truncated_stream_fails_cleanly(tmp_path):
    payload = b"x" * (2 * 65536)
    p = tmp_path / "t.pgz"
    _write_pgzf(str(p), payload, bufsize=65536)
    data = open(p, "rb").read()
    for cut in (len(data) // 3, len(data) - 7):
        q = tmp_path / f"cut{cut}.pgz"
        open(q, "wb").write(data[:cut])
        with pytest.raises(Exception):
            with PgzfReader(str(q)) as r:
                if r.read() != payload:
                    raise EOFError("truncated pgzf returned partial data")


def test_pgzf_reads_plain_gzip(tmp_path):
    p = tmp_path / "plain.gz"
    with gzip.open(p, "wb") as f:
        f.write(b"hello bsalign" * 1000)
    with open_pgzf(str(p)) as r:
        assert r.read() == b"hello bsalign" * 1000


def test_buffered_writer_propagates_write_errors():
    class Boom(io.RawIOBase):
        def writable(self):
            return True

        def write(self, data):
            raise OSError("disk full")

    w = BufferedWriter(Boom())
    with pytest.raises(OSError):
        for _ in range(1000):
            w.write(b"x" * 1024)
        w.close()


def test_buffered_writer_orders_chunks(tmp_path):
    p = tmp_path / "ord.txt"
    with BufferedWriter(str(p)) as w:
        for i in range(500):
            w.write(f"{i}\n")
    assert open(p).read().splitlines() == [str(i) for i in range(500)]


def test_pgzf_across_packages(tmp_path):
    """Each package reads the other's pgzf; the compressed bytes agree."""
    rng = np.random.default_rng(4)
    payload = rng.integers(32, 127, 2 * 65536 + 999).astype(np.uint8) \
        .tobytes()
    pt, pj = str(tmp_path / "t.pgz"), str(tmp_path / "j.pgz")
    _write_pgzf(pt, payload, 65536)
    _write_pgzf(pj, payload, 65536, JP.PgzfWriter)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    with JP.PgzfReader(pt) as r:
        assert r.kind == "pgzf" and r.read() == payload
    with PgzfReader(pj) as r:
        assert r.kind == "pgzf" and r.read() == payload


def test_read_fastx_pgzf_and_gzip(tmp_path, monkeypatch):
    """The same records from a pgzf file (io.pgzf.PgzfWriter, several
    blocks), a plain gzip file and the plain text, in both packages; the
    port opens both gzip files through its own io.filereader."""
    from bsalign_tpu_torch.io import filereader
    opened = []
    open_binary = filereader.open_binary
    monkeypatch.setattr(filereader, "open_binary",
                        lambda p: opened.append(p) or open_binary(p))
    rng = np.random.default_rng(5)
    text = "".join(
        f">r{i} len={n}\n{''.join('ACGT'[b] for b in rng.integers(0, 4, n))}"
        f"\n" if i % 3 else
        f"@r{i}\n{''.join('ACGT'[b] for b in rng.integers(0, 4, n))}\n+\n"
        f"{'I' * n}\n"
        for i, n in enumerate(rng.integers(50, 3000, 40)))
    plain = tmp_path / "r.fa"
    plain.write_text(text)
    with PgzfWriter(str(tmp_path / "r.fa.gz"), bufsize=1 << 14, ncpu=2) as w:
        w.write(text.encode())
    with gzip.open(tmp_path / "g.fa.gz", "wb") as f:
        f.write(text.encode())
    assert sniff(str(tmp_path / "r.fa.gz")) == "pgzf"

    def recs(mod, path):
        return [(r.tag, r.desc, r.seq) for r in mod.read_fastx(str(path))]
    want = recs(S, plain)
    assert len(want) == 40
    for path in ("r.fa.gz", "g.fa.gz"):
        assert recs(S, tmp_path / path) == want
        assert recs(JS, tmp_path / path) == want
    assert [os.path.basename(p) for p in opened] == ["r.fa.gz", "g.fa.gz"]


def test_basebank_pack_fetch_revcomp():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 777).astype(np.uint8)
    b = rng.integers(0, 4, 100).astype(np.uint8)
    bb = S.BaseBank()
    bb.push_codes(a)
    bb.push_codes(b, rev=True)
    assert len(bb) == 877
    assert np.array_equal(bb.get(0, 777), a)
    assert np.array_equal(bb.get(777, 100), 3 - b[::-1])
    assert np.array_equal(bb.get(0, 777, rev=True), 3 - a[::-1])
    assert np.array_equal(bb.get(31, 66), a[31:97])
    jb = JS.BaseBank()
    jb.push_codes(a)
    jb.push_codes(b, rev=True)
    assert np.array_equal(bb.dump()["words"], jb.dump()["words"])


def test_packed_seqbank_roundtrip(tmp_path):
    """Dumped by the port, loaded by both packages, and the other way."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 4, 513).astype(np.uint8)
    pb = S.PackedSeqBank()
    pb.push("r1", "ACGTACGT")
    pb.push("r2", a)
    assert pb.rid_of("r2") == 1 and pb.rid_of("r3") == -1
    assert np.array_equal(pb.get(1), a)
    path = str(tmp_path / "sb.obj")
    objstore.dump_obj_file(pb.dump(), path)
    from bsalign_tpu.utils import objstore as JO
    for mod, store in ((S, objstore), (JS, JO)):
        pb2 = mod.PackedSeqBank.load(store.load_obj_file(path))
        assert pb2.tags == ["r1", "r2"]
        assert np.array_equal(pb2.get(1), a)
        assert np.array_equal(pb2.get(0), S.encode_dna("ACGTACGT"))
    jpath = str(tmp_path / "jsb.obj")
    jb = JS.PackedSeqBank()
    jb.push("r1", "ACGTACGT")
    jb.push("r2", a)
    JO.dump_obj_file(jb.dump(), jpath)
    assert open(jpath, "rb").read() == open(path, "rb").read()


def test_kmer_utils_and_helpers():
    km = S.seq2kmers(S.encode_dna("ACGTAC"), 3)
    assert list(km) == [6, 27, 44, 49]
    assert S.kmer_revcomp(6, 3) == 27
    assert list(S.canonical_kmers(S.encode_dna("ACGTAC"), 3)) == \
        [6, 6, 44, 44]
    rng = np.random.default_rng(3)
    c = rng.integers(0, 4, 200).astype(np.uint8)
    assert np.array_equal(S.canonical_kmers(c, 11), JS.canonical_kmers(c, 11))
    assert S.decode_dna(c) == JS.decode_dna(c)
    assert np.array_equal(S.revcomp_codes(c), JS.revcomp_codes(c))
    buf = io.StringIO()
    S.write_fasta(buf, "x", "ACGTACGTAC", 4)
    assert buf.getvalue() == ">x\nACGT\nACGT\nAC\n"
    sb = S.SeqBank()
    sb.push("a", "ACGT")
    sb.push("b", c)
    assert len(sb) == 2 and np.array_equal(sb.seqs[1], c)


def test_workers_and_sysinfo():
    with workers.OrderedPool(3, lambda x: x * x) as pool:
        assert list(pool.map(range(20))) == [x * x for x in range(20)]
    assert list(workers.Prefetcher(iter(range(50)), depth=4)) == \
        list(range(50))
    info = sysinfo.get_linux_sys_info()
    assert info["mem_total"] >= info["mem_available"] > 0
    assert sysinfo.proc_stat_info()["rss_bytes"] > 0
    buf = io.StringIO()
    sysinfo.print_proc_stat_info(out=buf)
    assert buf.getvalue().startswith("[PROC] utime=")


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """BSA_PROFILE_DIR: the CLI's run leaves a torch.profiler Chrome trace
    (CPU activity only, for --device cpu); unset, nothing is written."""
    import contextlib
    import json
    from bsalign_tpu_torch import cli
    from .util import gen_pair, write_pairs_fasta
    rng = np.random.default_rng(9)
    fa = str(tmp_path / "p.fa")
    write_pairs_fasta(fa, [gen_pair(rng, 60, 0.1)])
    monkeypatch.setenv("BSA_PROFILE_DIR", str(tmp_path / "prof"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["edit", "--device", "cpu", fa]) == 0
    [trace] = os.listdir(tmp_path / "prof")
    assert trace == f"trace-{os.getpid()}.json"
    assert json.load(open(tmp_path / "prof" / trace))["traceEvents"]
    monkeypatch.delenv("BSA_PROFILE_DIR")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["edit", "--device", "cpu", fa]) == 0
    assert len(os.listdir(tmp_path / "prof")) == 1
