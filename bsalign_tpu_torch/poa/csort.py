"""Deterministic sort/permutation helpers matching the reference runtime.

The reference's sort_array (sort.h:137-198) is an unstable median-of-3
quicksort that skips runs of <= 5 elements and finishes with a bubble pass;
tie ORDER therefore depends on the exact partition sequence, and several POA
stages sort keys with ties — so the algorithm is reproduced step for step.
"""
from __future__ import annotations

from typing import Callable, List


def c_sort_array(rs: List, gt: Callable) -> None:
    """In-place sort; gt(a, b) mirrors the macro's is_a_greater_than_b."""
    n = len(rs)
    if n < 2:
        return
    stack = [(0, n - 1)]
    while stack:
        s, e = stack.pop()
        m = s + (e - s) // 2
        if gt(rs[s], rs[m]):
            rs[s], rs[m] = rs[m], rs[s]
        if gt(rs[m], rs[e]):
            rs[e], rs[m] = rs[m], rs[e]
            if gt(rs[s], rs[m]):
                rs[s], rs[m] = rs[m], rs[s]
        p = rs[m]
        i = s + 1
        j = e - 1
        while True:
            while gt(p, rs[i]):
                i += 1
            while gt(rs[j], p):
                j -= 1
            if i < j:
                rs[i], rs[j] = rs[j], rs[i]
                i += 1
                j -= 1
            else:
                break
        if i == j:
            i += 1
            j -= 1
        if j - s > e - i:
            if s + 4 < j:
                stack.append((s, j))
            if i + 4 < e:
                stack.append((i, e))
        else:
            if i + 4 < e:
                stack.append((i, e))
            if s + 4 < j:
                stack.append((s, j))
    # final bubble pass (stabilizes small runs)
    for i in range(n):
        moved = False
        for j in range(n - 1, i, -1):
            if gt(rs[j - 1], rs[j]):
                rs[j - 1], rs[j] = rs[j], rs[j - 1]
                moved = True
        if not moved:
            break


def shuffle_array(dat: List, ord_: List[int]) -> None:
    """In-place: dat'[j] = dat[ord_[j]] (sort.h:550-565)."""
    tmp = [dat[o] for o in ord_]
    dat[:] = tmp
