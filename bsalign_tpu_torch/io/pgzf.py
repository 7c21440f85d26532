"""PGZF — parallel blocked gzip with random access.

Format- and capability-equivalent of the reference's pgzf.h (901 LoC): each
block is a standalone RFC-1952 gzip member whose FEXTRA carries
  ZS (4 bytes): total member size (30B header + raw-deflate data + 8B tail)
  ZX (6 bytes): in block 0 the total uncompressed size; in every 64th block
                a skip-list offset patched at close (write_index_pgzf,
                pgzf.h:621-643)
so any block can be located and inflated independently. Deflate/inflate run
on an OrderedPool (zlib releases the GIL), mirroring the reference's
`thread_beg_def(pgz)` worker pool (pgzf.h:32). Plain single-stream gzip
files are read transparently (PGZF_MODE_R_GZ).
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import BinaryIO

from ..utils.workers import OrderedPool, Prefetcher

HEAD_SIZE = 30
TAIL_SIZE = 8
ZS_OFFSET = 16
ZX_OFFSET = 24
INDEX_BIN = 64
DEFAULT_BUFSIZE = 1 << 24


def _gen_header(z_size: int) -> bytes:
    h = bytearray(30)
    h[0:4] = b"\x1f\x8b\x08\x04"      # ID1 ID2 CM=deflate FLG=FEXTRA
    h[9] = 3                          # OS = unix
    h[10] = 18                        # XLEN
    h[12:16] = b"ZS\x04\x00"
    h[16:20] = struct.pack("<I", z_size)
    h[20:24] = b"ZX\x06\x00"
    return bytes(h)


def _parse_header(buf: bytes):
    """Returns (kind, hlen, zsval, zxval); kind in {'pgzf','gz',None}."""
    if len(buf) < 10 or buf[0] != 0x1F or buf[1] != 0x8B or buf[2] != 8:
        return None, 0, 0, 0
    flg = buf[3]
    off = 10
    zsval = zxval = 0
    is_pgzf = False
    if flg & 0x04:                    # FEXTRA
        if len(buf) < off + 2:
            return None, 0, 0, 0
        xlen = struct.unpack_from("<H", buf, off)[0]
        off += 2
        end = off + xlen
        while off + 4 <= end:
            si1, si2 = buf[off], buf[off + 1]
            sl = struct.unpack_from("<H", buf, off + 2)[0]
            off += 4
            if si1 == ord("Z") and si2 == ord("S") and sl == 4:
                is_pgzf = True
                zsval = struct.unpack_from("<I", buf, off)[0]
            elif si1 == ord("Z") and si2 == ord("X") and sl == 6:
                zxval = int.from_bytes(buf[off:off + 6], "little")
            off += sl
        off = end
    if flg & 0x08:                    # FNAME
        off = buf.index(b"\0", off) + 1
    if flg & 0x10:                    # FCOMMENT
        off = buf.index(b"\0", off) + 1
    if flg & 0x02:                    # FHCRC
        off += 2
    return ("pgzf" if is_pgzf else "gz"), off, zsval, zxval


def _deflate_block(args):
    data, level = args
    raw = zlib.compressobj(level, zlib.DEFLATED, -15, 9)
    z = raw.compress(data) + raw.flush()
    crc = zlib.crc32(data)
    member = (_gen_header(HEAD_SIZE + len(z) + TAIL_SIZE) + z
              + struct.pack("<II", crc, len(data) & 0xFFFFFFFF))
    return member


def _inflate_block(z: bytes) -> bytes:
    return zlib.decompress(z, -15)


class PgzfWriter(io.RawIOBase):
    def __init__(self, path_or_file, bufsize: int = DEFAULT_BUFSIZE,
                 ncpu: int = 4, level: int = 6):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._file: BinaryIO = open(path_or_file, "w+b")
            self._own = True
        else:
            self._file = path_or_file
            self._own = False
        try:
            self._offset = self._file.tell()
            self._seekable = True
        except (OSError, io.UnsupportedOperation):
            self._offset = 0
            self._seekable = False
        self.bufsize = bufsize
        self.level = level
        self._buf = bytearray()
        self._pool = OrderedPool(ncpu, _deflate_block)
        self._pending = 0
        self.tot_in = 0
        self.tot_out = 0
        self.boffs = [0]              # compressed offset after each block

    def write(self, data) -> int:
        self._buf += data
        self.tot_in += len(data)
        while len(self._buf) >= self.bufsize:
            self._submit(bytes(self._buf[:self.bufsize]))
            del self._buf[:self.bufsize]
        return len(data)

    def _submit(self, block: bytes) -> None:
        self._pool.submit((block, self.level))
        self._pending += 1
        if self._pending >= self._pool.n * 2:
            self._drain(self._pool.n)

    def _drain(self, leave: int = 0) -> None:
        it = self._pool.collect()
        while self._pending > leave:
            member = next(it)
            self._file.write(member)
            self.tot_out += len(member)
            self.boffs.append(self.tot_out)
            self._pending -= 1

    def close(self) -> None:
        if self.closed:
            return
        if self._buf or self.tot_in == 0:
            self._submit(bytes(self._buf))
            self._buf.clear()
        self._drain(0)
        self._write_index()
        self._pool.close()
        if self._own:
            self._file.close()
        else:
            self._file.flush()
        super().close()

    def _write_index(self) -> None:
        """Patch ZX fields: block 0 gets the total uncompressed size; every
        64th block gets a skip offset (write_index_pgzf, pgzf.h:621)."""
        if not self._seekable:
            return
        f = self._file
        f.seek(self._offset + ZX_OFFSET)
        f.write(self.tot_in.to_bytes(6, "little"))
        i, x = INDEX_BIN, 1
        while i + INDEX_BIN < len(self.boffs):
            f.seek(self._offset + self.boffs[x] + ZX_OFFSET)
            f.write(self.boffs[i + INDEX_BIN].to_bytes(6, "little"))
            i += INDEX_BIN
            x += 1
        f.seek(0, os.SEEK_END)


class PgzfReader(io.RawIOBase):
    """Reads PGZF (parallel, random access) and plain gzip (sequential)."""

    def __init__(self, path_or_file, ncpu: int = 4,
                 bufsize: int = DEFAULT_BUFSIZE):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._file: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._file = path_or_file
            self._own = False
        try:
            self._offset = self._file.tell()
            self._seekable = True
        except (OSError, io.UnsupportedOperation):
            self._offset = 0
            self._seekable = False
        head = self._file.read(HEAD_SIZE)
        self.kind, _, zs, zx = _parse_header(head)
        if self.kind is None:
            raise ValueError("not a gzip/pgzf stream")
        self.xsize = zx               # total uncompressed (0 if unknown)
        self._file.seek(self._offset)
        self._pos = 0
        if self.kind == "pgzf":
            self._iter = iter(Prefetcher(self._pgzf_blocks(ncpu), depth=4))
        else:
            self._iter = iter(self._gz_chunks(bufsize))
        self._cur = b""
        self._cur_off = 0

    def _member_sizes(self):
        """Yield (file_offset, member_size) for each block."""
        off = self._offset
        f = self._file
        while True:
            f.seek(off)
            head = f.read(HEAD_SIZE)
            if len(head) < HEAD_SIZE:
                return
            kind, _, zs, _ = _parse_header(head)
            if kind != "pgzf" or zs == 0:
                return
            yield off, zs
            off += zs

    def _pgzf_blocks(self, ncpu):
        def gen_payloads():
            for off, zs in self._member_sizes():
                self._file.seek(off + HEAD_SIZE)
                body = self._file.read(zs - HEAD_SIZE)
                yield body[:-TAIL_SIZE]
        pool = OrderedPool(ncpu, _inflate_block)
        try:
            yield from pool.map(gen_payloads())
        finally:
            pool.close()

    def _gz_chunks(self, bufsize):
        self._file.seek(self._offset)
        d = zlib.decompressobj(zlib.MAX_WBITS | 32)
        while True:
            raw = self._file.read(bufsize)
            if not raw:
                break
            out = d.decompress(raw)
            if out:
                yield out
            while d.eof and (d.unused_data or self._file.peek(1)
                             if hasattr(self._file, "peek") else d.unused_data):
                rest = d.unused_data
                if not rest:
                    break
                d = zlib.decompressobj(zlib.MAX_WBITS | 32)
                out = d.decompress(rest)
                if out:
                    yield out

    def read(self, n: int = -1) -> bytes:
        out = []
        want = n if n >= 0 else None
        while want is None or want > 0:
            if self._cur_off < len(self._cur):
                take = len(self._cur) - self._cur_off if want is None \
                    else min(want, len(self._cur) - self._cur_off)
                out.append(self._cur[self._cur_off:self._cur_off + take])
                self._cur_off += take
                if want is not None:
                    want -= take
                continue
            try:
                self._cur = next(self._iter)
                self._cur_off = 0
            except StopIteration:
                break
        res = b"".join(out)
        self._pos += len(res)
        return res

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)

    def seek_block(self, idx: int) -> None:
        """Random access: position at the start of block idx (seek_pgzf,
        pgzf.h:750 — hops members via their ZS sizes / ZX skips)."""
        if self.kind != "pgzf" or not self._seekable:
            raise io.UnsupportedOperation("seek on non-pgzf stream")
        sizes = list(self._member_sizes())
        if idx >= len(sizes):
            raise EOFError(f"block {idx} beyond {len(sizes)}")
        off = sizes[idx][0]
        self._file.seek(off)

        def gen():
            o = off
            f = self._file
            while True:
                f.seek(o)
                head = f.read(HEAD_SIZE)
                if len(head) < HEAD_SIZE:
                    return
                kind, _, zs, _ = _parse_header(head)
                if kind != "pgzf" or zs == 0:
                    return
                body = f.read(zs - HEAD_SIZE)
                yield _inflate_block(body[:-TAIL_SIZE])
                o += zs
        self._iter = iter(gen())
        self._cur = b""
        self._cur_off = 0

    def close(self) -> None:
        if self.closed:
            return
        if self._own:
            self._file.close()
        super().close()


def open_pgzf(path, mode: str = "rb", **kw):
    if "w" in mode:
        return PgzfWriter(path, **kw)
    return PgzfReader(path, **kw)
