"""The benchmark's own counts, held to values worked out by hand, and the
configurations' counts and weights pinned to the values they read before
each reference took over its own stage sizes and FLOP count."""

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import harness, weights, yardstick
from benchmark.reference import model as ref
from benchmark.tests import tiny


def test_scan_bytes_and_operations_of_one_stage():
    cfg = ref.Cfg({"N": 32, "M": 64, "dim_chunk": 8, "division_dimension": [32, 64]})
    # 64x64 image, batch 1: z is 1x1x32, y 4x4; q=0 codes z and the 4 base slices
    sizes = ref.stage_sizes(cfg, 1, 64, 64, 0.0)
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


# (config, batch, height, width, quality): (stage sizes, chain FLOPs, the scans'
# encode bytes, encode operations, decode bytes, decode operations at 512 lanes,
# 12,345 payload words and the CDF lengths of CDF_LENGTH)
PINNED = {
    ("flagship", 1, 512, 768, 0.0): ([18432] + [49152] * 10, 706079490048,
        (4081664, 15298560, 4681022, 6119424)),
    ("flagship", 1, 512, 768, 5.3): ([18432] + [49152] * 10 + [491520], 916858994688,
        (8013824, 30044160, 9110470, 12017664)),
    ("flagship", 1, 512, 768, 10.0): ([18432] + [49152] * 10 + [491520], 916858994688,
        (8013824, 30044160, 9110470, 12017664)),
    ("flagship", 8, 512, 768, 0.0): ([147456] + [393216] * 10, 5648635920384,
        (32638976, 122388480, 36807998, 48955392)),
    ("flagship", 8, 512, 768, 5.3): ([147456] + [393216] * 10 + [3932160], 7334871957504,
        (64096256, 240353280, 72203206, 96141312)),
    ("flagship", 8, 512, 768, 10.0): ([147456] + [393216] * 10 + [3932160], 7334871957504,
        (64096256, 240353280, 72203206, 96141312)),
    ("flagship", 1, 1024, 2048, 0.0): ([98304] + [262144] * 10, 3765757280256,
        (21760000, 81592320, 24569150, 32636928)),
    ("flagship", 1, 1024, 2048, 5.3): ([98304] + [262144] * 10 + [2621440], 4889914638336,
        (42731520, 160235520, 48167878, 64094208)),
    ("flagship", 1, 1024, 2048, 10.0): ([98304] + [262144] * 10 + [2621440], 4889914638336,
        (42731520, 160235520, 48167878, 64094208)),
    ("rem", 1, 512, 768, 0.0): ([18432] + [49152] * 10, 706079490048,
        (4081664, 15298560, 4681022, 6119424)),
    ("rem", 1, 512, 768, 5.3): ([18432] + [49152] * 20, 944730144768,
        (8013824, 30044160, 9162382, 12017664)),
    ("rem", 1, 512, 768, 10.0): ([18432] + [49152] * 20, 944730144768,
        (8013824, 30044160, 9162382, 12017664)),
    ("rem", 8, 512, 768, 0.0): ([147456] + [393216] * 10, 5648635920384,
        (32638976, 122388480, 36807998, 48955392)),
    ("rem", 8, 512, 768, 5.3): ([147456] + [393216] * 20, 7557841158144,
        (64096256, 240353280, 72255118, 96141312)),
    ("rem", 8, 512, 768, 10.0): ([147456] + [393216] * 20, 7557841158144,
        (64096256, 240353280, 72255118, 96141312)),
    ("rem", 1, 1024, 2048, 0.0): ([98304] + [262144] * 10, 3765757280256,
        (21760000, 81592320, 24569150, 32636928)),
    ("rem", 1, 1024, 2048, 5.3): ([98304] + [262144] * 20, 5038560772096,
        (42731520, 160235520, 48219790, 64094208)),
    ("rem", 1, 1024, 2048, 10.0): ([98304] + [262144] * 20, 5038560772096,
        (42731520, 160235520, 48219790, 64094208)),
}
CDF_LENGTH = (10 + np.arange(256) % 7).astype(np.int32)
# sha256 over each name and its tensor's bytes, in spec order: TINY widths, CPU
WEIGHTS_SHA256 = {"flagship": "330bc4b90a4c1097ccd1584a0ee9c565527802012f9f6787258fd79a9407781c",
                  "rem": "8ba8209e2299a0e576709ef941552c1bbd8c227c7c82873f3d9004deaebbef55"}


def _conf(name):
    return json.loads((tiny.REPO / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,batch,h,w", sorted({k[:4] for k in PINNED}))
def test_configuration_counts_pinned(name, batch, h, w):
    conf = _conf(name)
    cfg = harness.reference(tiny.REPO, conf).Cfg(conf["model"])
    for q in (0.0, 5.3, 10.0):
        sizes, flops, work = PINNED[(name, batch, h, w, q)]
        assert yardstick.reference_of(cfg).stage_sizes(cfg, batch, h, w, q) == sizes
        assert yardstick.chain_flops(cfg, batch, h, w, q) == flops
        got = yardstick.scan_work(cfg, CDF_LENGTH, batch, h, w, q, 512, 12345)
        assert (got["encode_bytes"], got["encode_ops"], got["decode_bytes"], got["decode_ops"]) == work


@pytest.mark.parametrize("name", ["flagship", "rem"])
def test_configuration_weights_pinned(name):
    conf = _conf(name)
    conf["model"].update(tiny.TINY_MODEL)
    P = weights.config_weights(harness.reference(tiny.REPO, conf), conf, "cpu")
    digest = hashlib.sha256()
    for k, v in P.items():
        digest.update(k.encode())
        digest.update(v.contiguous().numpy().tobytes())
    assert digest.hexdigest() == WEIGHTS_SHA256[name]


def test_declared_kinds_and_ones():
    spec = [("a.weight", (64, 32, 3, 3), "conv"), ("n.gain", (96,), "ones"), ("n.bias", (96,), "bias"),
            ("p.weight", (128, 256), "proj"), ("s.scale", (5, 7), "half")]
    kinds = {"proj": {"std": 0.5}, "half": {"const": 0.5}}
    P = weights.draw_weights(spec, 2**33 + 1, "cpu", kinds=kinds)
    assert torch.equal(P["n.gain"], torch.ones(96)) and torch.equal(P["n.bias"], torch.zeros(96))
    assert torch.equal(P["s.scale"], torch.full((5, 7), 0.5))
    assert abs(float(P["p.weight"].std()) - 0.5) < 0.02
    # declared kinds that the spec does not name draw nothing of their own
    plain = [t for t in spec if t[2] in ("conv", "ones", "bias")]
    a = weights.draw_weights(plain, 2**33 + 1, "cpu")
    b = weights.draw_weights(plain, 2**33 + 1, "cpu", kinds=kinds)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the configuration's "init" still overrides a declared kind by name
    P = weights.draw_weights(spec, 2**33 + 1, "cpu", {r"s\.scale": {"const": 3.0}}, kinds)
    assert torch.equal(P["s.scale"], torch.full((5, 7), 3.0))
