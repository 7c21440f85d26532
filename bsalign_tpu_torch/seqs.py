"""Sequence encoding and FASTA/FASTQ reading (port of bsalign_tpu.seqs).

Sequences are NumPy uint8 arrays of 2-bit codes (dna.h:13-58); the parser
follows filereader.h:609-744, with the format sniffed per record.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
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
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "rt")


def read_fastx(path_or_handle) -> Iterator[SeqRecord]:
    """Stream FASTA/FASTQ records (plain or gzip)."""
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
                parts = line[1:].split(None, 1)
                tag = parts[0] if parts else ""
                desc = parts[1] if len(parts) > 1 else ""
                chunks: List[str] = []
                line = handle.readline()
                while line and not line.startswith((">", "@")):
                    chunks.append(line.strip())
                    line = handle.readline()
                yield SeqRecord(tag, desc, "".join(chunks))
            elif line.startswith("@"):
                parts = line[1:].split(None, 1)
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
