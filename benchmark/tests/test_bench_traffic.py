"""The traffic generator and the work count."""
import json
import os

import numpy as np

from harness import core, roofline, traffic


def test_bench_generator_repeats_from_its_seed():
    spec = json.load(open(os.path.join(core.BENCH, "workloads",
                                       "reads.2kb.json")))
    spec = dict(spec, pairs_per_call=8)
    seed = 2 ** 33 + 7
    a = traffic.make_calls(spec, seed)
    b = traffic.make_calls(spec, seed)
    c = traffic.make_calls(spec, seed + 1)
    assert len(a) == traffic.ORDERS and all(len(x) == 8 for x in a)
    for (qa, ta), (qb, tb) in zip(sum(a, []), sum(b, [])):
        assert np.array_equal(qa, qb) and np.array_equal(ta, tb)
    assert not np.array_equal(a[0][0][1], c[0][0][1])
    assert all(len(t) == 2000 for call in a for _, t in call)
    assert traffic.target_bases(a[0]) == 8 * 2000
    # every call holds the same pairs, calls in different orders
    ids = [[id(q) for q, _ in call] for call in a]
    assert all(sorted(x) == sorted(ids[0]) for x in ids)
    assert len({tuple(x) for x in ids}) == traffic.ORDERS


def test_bench_generator_error_model():
    """10% error split 23:31:46 into substitutions, insertions and
    deletions: a target base keeps (1 - del) / (1 - ins) query bases on
    average and gains ins / (1 - ins) inserted ones."""
    qs, ts = traffic.gen_pairs_fast(200, 2000, 0.10, 5)
    d = np.mean([len(q) - len(t) for q, t in zip(qs, ts)]) / 2000
    assert abs(d - (0.031 - 0.046) / (1 - 0.031)) < 0.002


def test_bench_work_count_by_hand():
    # two pairs: 100 x 2 kb targets at band 2,048 and 512, affine gaps
    ops, nbytes, cells = roofline.align_work(
        [(1970, 2000, 2048), (1990, 2000, 512)], 1)
    assert cells == 2000 * 2048 + 2000 * 512
    assert ops == 10 * cells
    assert nbytes == (1970 + 2000 + 1990 + 2000) + 0.5 * cells
    ops2, nbytes2, _ = roofline.align_work([(10, 20, 16)], 2)
    assert (ops2, nbytes2) == (18 * 320, 30 + 3 * 320)
    t, by = roofline.bound_s(67e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = roofline.bound_s(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
