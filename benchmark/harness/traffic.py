"""The traffic generator: seeded read pairs by the upstream paper's error
model, cut into calls as a traffic file (benchmark/workloads/<name>.json)
says.

`gen_pairs_fast` is a frozen copy of chip_smoke.py's (the model of
tools/gen_pairs.py and bsalign's example/ScriptsForPaper.txt: a uniform
random target; before each target base a geometric run of random inserted
bases, then the base substituted, deleted or kept; substitutions,
insertions and deletions in the shares 23:31:46).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]     # (query, target), codes 0-3
SUB_INS_DEL = (23, 31, 46)
ORDERS = 4        # orders of the pool that the calls cycle through


def gen_pairs_fast(n: int, length: int, err: float = 0.10, seed=0):
    """n (query, target) pairs of `length`-base targets, queries at error
    rate err split into substitutions, insertions and deletions 23:31:46."""
    rng = np.random.default_rng(seed)
    tot = float(sum(SUB_INS_DEL))
    p_sub, p_ins, p_del = (err * s / tot for s in SUB_INS_DEL)
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, length).astype(np.uint8)
        k = rng.geometric(1 - p_ins, length) - 1          # insertions
        r = rng.random(length) * (1 - p_ins)
        keep = (r >= p_sub + p_del) | (r < p_sub)
        val = np.where(r < p_sub, (t + rng.integers(1, 4, length)) & 3, t)
        cnt = k + keep
        owner = np.repeat(np.arange(length), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ins = np.arange(len(owner)) - first < k[owner]
        q = np.where(ins, rng.integers(0, 4, len(owner)), val[owner])
        qs.append(q.astype(np.uint8))
        ts.append(t)
    return qs, ts


def make_calls(traffic: dict, seed: int) -> List[List[Pair]]:
    """The calls a run cycles through: ORDERS seeded orders of one pool of
    `pairs_per_call` distinct pairs with targets of `target_len`, all drawn
    from the seed. Every seed gives the same sizes, and every call the same
    shapes; consecutive calls hold the pairs in different orders, so an
    answer left over from the call before is a wrong answer."""
    n = traffic["pairs_per_call"]
    qs, ts = gen_pairs_fast(n, traffic["target_len"], traffic["error"],
                            [seed, 1])
    pool = list(zip(qs, ts))
    rng = np.random.default_rng([seed, 4])
    return [[pool[i] for i in rng.permutation(n)]
            for _ in range(ORDERS)]


def target_bases(call: Sequence[Pair]) -> int:
    return int(sum(len(t) for _, t in call))
