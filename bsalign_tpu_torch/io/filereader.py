"""FileReader — pull-parser over plain / gzip / pgzf files.

Equivalent of filereader.h: file type sniffed by magic bytes
(push_filereader, filereader.h:284), optional async prefetch thread
(filereader.h:105-183), line iteration, table splitting, and FASTA/FASTQ
record parsing (readseq_filereader, filereader.h:609 — delegated to
seqs.read_fastx_iter over this layer).
"""
from __future__ import annotations

import io
import os
from typing import Iterator, List, Optional

from ..utils.workers import Prefetcher
from .pgzf import PgzfReader, _parse_header


def sniff(path: str) -> str:
    """'pgzf' | 'gz' | 'plain' by magic bytes."""
    with open(path, "rb") as f:
        head = f.read(30)
    kind, _, _, _ = _parse_header(head)
    return kind or "plain"


def open_binary(path: str, ncpu: int = 4):
    """Binary stream with transparent decompression."""
    if path == "-":
        return io.BufferedReader(os.fdopen(os.dup(0), "rb", closefd=True))
    kind = sniff(path)
    if kind in ("pgzf", "gz"):
        return io.BufferedReader(PgzfReader(path, ncpu=ncpu))
    return open(path, "rb")


class FileReader:
    """Line-oriented reader over one or more files with async prefetch."""

    def __init__(self, paths, async_prefetch: bool = True, ncpu: int = 4):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        self.async_prefetch = async_prefetch
        self.ncpu = ncpu

    def _lines(self) -> Iterator[bytes]:
        for p in self.paths:
            with open_binary(p, self.ncpu) as f:
                yield from f

    def __iter__(self) -> Iterator[str]:
        it = self._lines()
        if self.async_prefetch:
            it = iter(Prefetcher(it, depth=64))
        for line in it:
            yield line.decode("ascii", "replace").rstrip("\n")

    def tabs(self, sep: Optional[str] = None) -> Iterator[List[str]]:
        """Split each line into fields (the reference's table mode)."""
        for line in self:
            yield line.split(sep) if sep else line.split()
