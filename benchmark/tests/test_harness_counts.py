"""The benchmark's own counts, held to values worked out by hand."""

import numpy as np

from benchmark import yardstick
from benchmark.reference import model as ref


def test_scan_bytes_and_operations_of_one_stage():
    cfg = ref.Cfg({"N": 32, "M": 64, "dim_chunk": 8, "division_dimension": [32, 64]})
    # 64x64 image, batch 1: z is 1x1x32, y 4x4; q=0 codes z and the 4 base slices
    sizes = yardstick.stage_sizes(cfg, 1, 64, 64, 0.0)
    assert sizes == [32, 128, 128, 128, 128]
    cdf_length = np.full(32 + 64, 10)
    w = yardstick.scan_work(cfg, cdf_length, 1, 64, 64, 0.0, lanes=64, payload_words=100)
    cells = 64 + 4 * 128  # z pads 32 symbols to one row of 64 lanes
    assert w["encode_bytes"] == cells * 8 + 4 * 64
    assert w["encode_ops"] == 30 * cells
    assert w["decode_bytes"] == cells * 9 + 2 * 320 + 2 * 640 * 4 + 2 * 100 + 5 * (8 * 64 + 8)
    assert w["decode_ops"] == 12 * cells
    assert yardstick.bound_seconds(3.35e12, 0) == 1.0
    assert yardstick.bound_seconds(0, 33.5e12) == 1.0


def test_flops_of_one_convolution():
    import torch

    x = torch.empty((2, 16, 8, 12), device="meta")
    w = torch.empty((24, 16, 3, 3), device="meta")
    n = yardstick._count(lambda: torch.nn.functional.conv2d(x, w, padding=1))
    assert n == 2 * 2 * 24 * 16 * 9 * 8 * 12


def test_chain_counts_both_sides():
    cfg = ref.Cfg({"N": 32, "M": 64, "dim_chunk": 8, "division_dimension": [32, 64]})
    f0, f10 = yardstick.chain_flops(cfg, 1, 64, 64, 0.0), yardstick.chain_flops(cfg, 1, 64, 64, 10.0)
    assert 0 < f0 < f10
    assert yardstick.chain_flops(cfg, 2, 64, 64, 10.0) == 2 * f10


def test_peak_and_gate():
    assert yardstick.peak_flops("NVIDIA H100 80GB HBM3") == 66.9e12
    assert abs(yardstick.gated_share(66.9e12 * 0.5, 1.0, 66.9e12) - 0.5) < 1e-12
    try:
        yardstick.gated_share(66.9e12, 1.0, 66.9e12)
    except AssertionError:
        return
    raise AssertionError("a share of 1 must raise")
