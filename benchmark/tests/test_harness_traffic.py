"""The traffic generator: the same seed gives the same images and qualities."""

import numpy as np
import torch

from benchmark import traffic

MIX = {"height": 64, "width": 96, "batch": 2, "qualities": [0.0, 0.1, 5.5, 10.0], "pool": 3,
       "pool_seed": 2**33 + 5, "check_requests": 2, "check_span": 5}


def test_same_seed_same_inputs():
    a, b = traffic.image_pool(MIX, "cpu"), traffic.image_pool(MIX, "cpu")
    assert a.shape == (3, 64, 96, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    sa, sb = traffic.Schedule(MIX, 2**33 + 5), traffic.Schedule(MIX, 2**33 + 5)
    assert [sa(i) for i in range(40)] == [sb(i) for i in range(40)]
    assert sa.checked == sb.checked and len(sa.checked) == 2 and max(sa.checked) < 5


def test_other_seed_other_order_same_mix():
    a, b = traffic.image_pool(MIX, "cpu"), traffic.image_pool(dict(MIX, pool_seed=2), "cpu")
    assert not torch.equal(a, b)
    s1, s2 = traffic.Schedule(MIX, 1), traffic.Schedule(MIX, 2)
    q1 = [s1(i)[1] for i in range(40)]
    q2 = [s2(i)[1] for i in range(40)]
    assert q1 != q2
    # every cycle of four requests holds each quality once, whatever the seed
    for qs in (q1, q2):
        for c in range(10):
            assert sorted(qs[4 * c : 4 * c + 4]) == sorted(float(np.float32(q)) for q in MIX["qualities"])


def test_qualities_are_float32_and_batches_walk_the_pool():
    s = traffic.Schedule(MIX, 9)
    for i in range(12):
        idx, q = s(i)
        assert q == float(np.float32(q)) and len(idx) == 2
    seen = [j for i in range(3) for j in s(i)[0]]
    assert sorted(seen[:3]) == [0, 1, 2]
