"""Bit vector with O(1) rank and near-O(1) select.

Equivalent of the reference's BitVec (bitvec.h:40-250): set/clear/test bits,
then `index()` builds rank acceleration tables for rank1/select1 queries.
NumPy-backed (uint64 words) instead of macro-generated C arrays.
"""
from __future__ import annotations

import numpy as np


class BitVec:
    def __init__(self, n_bits: int = 0):
        self.n_bits = n_bits
        self.words = np.zeros((n_bits + 63) // 64 or 1, np.uint64)
        self._rank_blocks = None   # cumulative popcount per 64-bit word
        self._sel_samples = None   # word index of every 512th one

    # ---- mutation ----
    def resize(self, n_bits: int) -> None:
        nw = (n_bits + 63) // 64 or 1
        if nw > len(self.words):
            self.words = np.resize(self.words, nw)
            self.words[len(self.words):] = 0
        self.n_bits = n_bits
        self._rank_blocks = None

    def one(self, i: int) -> None:
        self.words[i >> 6] |= np.uint64(1) << np.uint64(i & 63)
        self._rank_blocks = None

    def zero(self, i: int) -> None:
        self.words[i >> 6] &= ~(np.uint64(1) << np.uint64(i & 63))
        self._rank_blocks = None

    def get(self, i: int) -> int:
        return int((self.words[i >> 6] >> np.uint64(i & 63)) & np.uint64(1))

    def set_all(self, bits: np.ndarray) -> None:
        """Bulk-load from a boolean array."""
        self.n_bits = len(bits)
        self.words = np.packbits(
            bits.astype(np.uint8), bitorder="little").view(np.uint8)
        pad = (-len(self.words)) % 8
        if pad:
            self.words = np.concatenate(
                [self.words, np.zeros(pad, np.uint8)])
        self.words = self.words.view(np.uint64).copy()
        self._rank_blocks = None

    # ---- queries ----
    def count_ones(self) -> int:
        return int(np.unpackbits(self.words.view(np.uint8)).sum())

    def index(self) -> None:
        """Build rank/select tables (reg_ones/index_bitvec equivalent)."""
        pops = np.unpackbits(
            self.words.view(np.uint8)).reshape(len(self.words), 64).sum(1)
        self._rank_blocks = np.concatenate(
            [[0], np.cumsum(pops)]).astype(np.int64)
        ones_total = int(self._rank_blocks[-1])
        # sample: word holding each 512th one (binary-search refined)
        marks = np.arange(0, ones_total, 512)
        self._sel_samples = np.searchsorted(
            self._rank_blocks[1:], marks, side="right")

    def rank1(self, i: int) -> int:
        """Number of ones in [0, i)."""
        if self._rank_blocks is None:
            self.index()
        w = i >> 6
        r = int(self._rank_blocks[w])
        rem = i & 63
        if rem:
            mask = (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
            r += bin(int(self.words[w] & mask)).count("1")
        return r

    def select1(self, k: int) -> int:
        """Position of the (k+1)-th one; -1 if out of range."""
        if self._rank_blocks is None:
            self.index()
        if k >= int(self._rank_blocks[-1]):
            return -1
        w = int(np.searchsorted(self._rank_blocks[1:], k, side="right"))
        rem = k - int(self._rank_blocks[w])
        word = int(self.words[w])
        for b in range(64):
            if (word >> b) & 1:
                if rem == 0:
                    return w * 64 + b
                rem -= 1
        return -1
