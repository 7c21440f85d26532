"""Sorting utilities: parallel sort, quick-median, merges.

Equivalent of the reference's sort.h macros: `sort_array` (sort.h:137) is
NumPy/list sort; `psort_array` (sort.h:199, pthread parallel quicksort)
becomes a chunked parallel merge sort over a thread pool; `quick_median_array`
(sort.h:268) is quickselect.
"""
from __future__ import annotations

import heapq
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np


def sort_array(a, key: Optional[Callable] = None):
    """In-place for lists, returns sorted np array for ndarray."""
    if isinstance(a, np.ndarray):
        return np.sort(a, kind="stable")
    a.sort(key=key)
    return a


def psort_array(a, n_threads: int = 4, key: Optional[Callable] = None):
    """Parallel chunked sort + k-way merge (psort_array, sort.h:199).

    For ndarrays NumPy's sort is already fast; threads only help for large
    object lists where `key` releases the GIL poorly — still provided for
    API parity and for ndarray chunk sorts that do release the GIL.
    """
    if isinstance(a, np.ndarray):
        if n_threads <= 1 or len(a) < 1 << 16:
            return np.sort(a, kind="stable")
        chunks = np.array_split(a, n_threads)
        with ThreadPoolExecutor(n_threads) as ex:
            parts = list(ex.map(lambda c: np.sort(c, kind="stable"), chunks))
        out = parts[0]
        for p in parts[1:]:
            merged = np.empty(len(out) + len(p), out.dtype)
            i = np.searchsorted(out, p)
            mask = np.zeros(len(merged), bool)
            mask[i + np.arange(len(p))] = True
            merged[mask] = p
            merged[~mask] = out
            out = merged
        return out
    sa = sorted(a, key=key)
    a[:] = sa
    return a


def quick_median_array(a: Sequence) -> float:
    """Median via quickselect semantics (quick_median_array, sort.h:268):
    returns element at index n//2 of the sorted order."""
    arr = np.asarray(a)
    if len(arr) == 0:
        return 0
    k = len(arr) // 2
    return arr[np.argpartition(arr, k)[k]]


def merge_sorted(lists: List[Sequence], key: Optional[Callable] = None):
    """K-way merge of pre-sorted sequences."""
    if key is None:
        return list(heapq.merge(*lists))
    return list(heapq.merge(*lists, key=key))
