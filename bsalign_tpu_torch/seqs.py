"""Sequence encoding and FASTA/FASTQ I/O (port of bsalign_tpu.seqs).

Counterpart of the reference's dna.h BaseBank/SeqBank and
filereader.h FASTA/Q parser (dna.h:13-58 base tables, filereader.h:609
readseq). Sequences are held as NumPy uint8 arrays of 2-bit codes; batch
packing for device transfer lives in bsalign_tpu_torch/align.
"""
from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np

# base -> 2bit code; everything unknown -> 4 (N) (dna.h:13-32)
_BASE_BIT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASE_BIT[ord(_c)] = _i
    _BASE_BIT[ord(_c.lower())] = _i

BIT_BASE = "ACGTN-acgtn*"  # dna.h:59


def encode_dna(seq: str | bytes, mask_n: bool = True) -> np.ndarray:
    """Encode an ASCII DNA string to 0..3 codes (N -> 0 when mask_n, mirroring
    2-bit BaseBank packing where code 4 & 3 == 0)."""
    if isinstance(seq, str):
        seq = seq.encode()
    codes = _BASE_BIT[np.frombuffer(seq, dtype=np.uint8)]
    if mask_n:
        codes = codes & 3
    return codes.astype(np.uint8)


def decode_dna(codes: np.ndarray) -> str:
    return "".join(BIT_BASE[c] for c in codes)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


@dataclass
class SeqRecord:
    tag: str
    desc: str
    seq: str
    qual: str | None = None

    @property
    def codes(self) -> np.ndarray:
        return encode_dna(self.seq)


def _open_maybe_gz(path: str) -> io.TextIOBase:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        # pgzf-aware (parallel blocked gzip with random access) — falls back
        # to plain single-stream gzip transparently (io/pgzf.py)
        from .io.filereader import open_binary
        return io.TextIOWrapper(open_binary(path))
    return open(path, "rt")


def read_fastx(path_or_handle) -> Iterator[SeqRecord]:
    """Stream FASTA/FASTQ records (plain or gzip). Parser behavior mirrors
    filereader.h:609-744: format sniffed per-record from '>' / '@'."""
    if isinstance(path_or_handle, str):
        handle = _open_maybe_gz(path_or_handle)
        owns = True
    else:
        handle = path_or_handle
        owns = False
    try:
        line = handle.readline()
        while line:
            line = line.rstrip("\n")
            if not line:
                line = handle.readline()
                continue
            if line.startswith(">"):
                header = line[1:]
                parts = header.split(None, 1)
                tag = parts[0] if parts else ""
                desc = parts[1] if len(parts) > 1 else ""
                chunks: List[str] = []
                line = handle.readline()
                while line and not line.startswith((">", "@")):
                    chunks.append(line.strip())
                    line = handle.readline()
                yield SeqRecord(tag, desc, "".join(chunks))
            elif line.startswith("@"):
                header = line[1:]
                parts = header.split(None, 1)
                tag = parts[0] if parts else ""
                desc = parts[1] if len(parts) > 1 else ""
                seq = handle.readline().strip()
                handle.readline()  # '+'
                qual = handle.readline().strip()
                yield SeqRecord(tag, desc, seq, qual)
                line = handle.readline()
            else:
                line = handle.readline()
    finally:
        if owns:
            handle.close()


def write_fasta(handle, tag: str, seq: str, width: int = 0) -> None:
    handle.write(f">{tag}\n")
    if width and width > 0:
        for i in range(0, len(seq), width):
            handle.write(seq[i : i + width] + "\n")
    else:
        handle.write(seq + "\n")


@dataclass
class SeqBank:
    """Named read set: list-of-arrays analog of dna.h:1179-1260 SeqBank."""

    tags: List[str] = field(default_factory=list)
    seqs: List[np.ndarray] = field(default_factory=list)

    def push(self, tag: str, seq: str | np.ndarray) -> None:
        self.tags.append(tag)
        if isinstance(seq, str):
            self.seqs.append(encode_dna(seq))
        else:
            self.seqs.append(np.asarray(seq, dtype=np.uint8) & 3)

    def __len__(self) -> int:
        return len(self.seqs)

    def clear(self) -> None:
        self.tags.clear()
        self.seqs.clear()

class BaseBank:
    """2-bit packed base store (dna.h:463-1170): bases packed big-endian
    within each 64-bit word (`bits2bit`, dna.h:63); push forward/reverse,
    fetch subsequences in either orientation, decode to 0-3 code arrays."""

    def __init__(self):
        self.words = np.zeros(16, np.uint64)
        self.size = 0

    def _encap(self, n: int) -> None:
        need = (self.size + n + 31) // 32
        if need > len(self.words):
            cap = max(need, len(self.words) * 2)
            self.words = np.resize(self.words, cap)
            self.words[(self.size + 31) // 32:] = 0

    def push_codes(self, codes: np.ndarray, rev: bool = False) -> None:
        codes = np.asarray(codes, np.uint64) & 3
        if rev:
            codes = 3 - codes[::-1]
        self._encap(len(codes))
        idx = self.size + np.arange(len(codes))
        w = idx >> 5
        sh = ((31 - (idx & 31)) << 1).astype(np.uint64)
        np.bitwise_or.at(self.words, w, codes << sh)
        self.size += len(codes)

    def push(self, seq: str, rev: bool = False) -> None:
        self.push_codes(encode_dna(seq), rev)

    def get(self, off: int, length: int, rev: bool = False) -> np.ndarray:
        """Decode codes [off, off+length); reverse-complement when rev
        (bitseq_basebank / revbitseq_basebank)."""
        idx = off + np.arange(length)
        w = idx >> 5
        sh = ((31 - (idx & 31)) << 1).astype(np.uint64)
        out = ((self.words[w] >> sh) & np.uint64(3)).astype(np.uint8)
        if rev:
            out = (3 - out[::-1]).astype(np.uint8)
        return out

    def __len__(self) -> int:
        return self.size

    def dump(self) -> dict:
        """Serializable payload for utils.objstore."""
        return {"words": self.words[: (self.size + 31) // 32].copy(),
                "size": self.size}

    @classmethod
    def load(cls, payload: dict) -> "BaseBank":
        bb = cls.__new__(cls)
        bb.words = np.array(payload["words"], np.uint64)
        bb.size = int(payload["size"])
        return bb


class PackedSeqBank:
    """Named read set over a shared 2-bit BaseBank (dna.h:1179-1260):
    tags + offsets + lengths + a tag->rid hash (cuhash equivalent)."""

    def __init__(self):
        self.bank = BaseBank()
        self.tags: List[str] = []
        self.offs: List[int] = []
        self.lens: List[int] = []
        self.index: dict = {}

    def push(self, tag: str, seq: str | np.ndarray) -> int:
        rid = len(self.tags)
        codes = encode_dna(seq) if isinstance(seq, str) else \
            (np.asarray(seq, np.uint8) & 3)
        self.offs.append(self.bank.size)
        self.lens.append(len(codes))
        self.bank.push_codes(codes)
        self.tags.append(tag)
        self.index[tag] = rid
        return rid

    def get(self, rid: int, rev: bool = False) -> np.ndarray:
        return self.bank.get(self.offs[rid], self.lens[rid], rev)

    def rid_of(self, tag: str) -> int:
        return self.index.get(tag, -1)

    def __len__(self) -> int:
        return len(self.tags)

    def dump(self) -> dict:
        d = self.bank.dump()
        d.update({"tags": "\x00".join(self.tags).encode(),
                  "offs": np.asarray(self.offs, np.int64),
                  "lens": np.asarray(self.lens, np.int64)})
        return d

    @classmethod
    def load(cls, payload: dict) -> "PackedSeqBank":
        sb = cls()
        sb.bank = BaseBank.load(payload)
        sb.tags = bytes(payload["tags"]).decode().split("\x00") \
            if len(payload["tags"]) else []
        sb.offs = [int(x) for x in payload["offs"]]
        sb.lens = [int(x) for x in payload["lens"]]
        sb.index = {t: i for i, t in enumerate(sb.tags)}
        return sb


# ---- kmer utilities (dna.h:63-360) ----

def seq2kmers(codes: np.ndarray, ksize: int) -> np.ndarray:
    """All forward kmers as packed 2-bit integers (beg_seq2kmers macro)."""
    codes = np.asarray(codes, np.uint64) & 3
    n = len(codes) - ksize + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    shifts = (np.arange(ksize)[::-1] * 2).astype(np.uint64)
    out = np.zeros(n, np.uint64)
    for j in range(ksize):
        out |= codes[j:j + n] << shifts[j]
    return out


def kmer_revcomp(kmer: int | np.ndarray, ksize: int):
    """Reverse-complement of packed kmer(s) (dna_rev_seq semantics)."""
    k = np.asarray(kmer, np.uint64)
    out = np.zeros_like(k)
    for i in range(ksize):
        base = (k >> np.uint64(2 * i)) & np.uint64(3)
        out |= (np.uint64(3) - base) << np.uint64(2 * (ksize - 1 - i))
    return out if out.shape else int(out)


def canonical_kmers(codes: np.ndarray, ksize: int) -> np.ndarray:
    fwd = seq2kmers(codes, ksize)
    rev = kmer_revcomp(fwd, ksize)
    return np.minimum(fwd, rev)
