"""The TCM cell from its own files: the TINY TCM (N 32, M 40, dim_chunk 8,
at 256x256) runs correct, traced and untraced, with its two span metrics;
three faults of the reference each come out not correct; the file's "tcm"
entry is checked; the reference's stages and FLOPs at the cell's 2048x1024
are pinned."""

import json

import pytest

from benchmark import harness, yardstick
from benchmark.tests import tiny

CELL = "tcm.clic2k_b1_q0"
TINY_TCM = {"N": 32, "M": 40, "dim_chunk": 8, "scale_table": {"min": 0.11, "max": 256.0, "levels": 32}}
MIX = {"height": 256, "width": 256, "batch": 1, "qualities": [0.0], "pool": 2, "pool_seed": 5,
       "warmup_qualities": [0.0], "profiled_requests": 2, "check_requests": 2, "check_span": 2}

# each fault as (the reference's text, what replaces it)
FAULTS = {
    # g_a's second ConvTransBlock without its Transformer half
    "ctb_without_transformer": (
        'trans_x = block(P, f"{p}.trans_block", trans_x.permute(0, 2, 3, 1), head_dim, ws, shifted)',
        'trans_x = trans_x.permute(0, 2, 3, 1) if p == "g_a.2" else '
        'block(P, f"{p}.trans_block", trans_x.permute(0, 2, 3, 1), head_dim, ws, shifted)'),
    # every SWAtten's Swin without its shifted block
    "swatten_without_shift": (
        't = block(P, f"{p}.non_local_block.block_2", t, ATTEN_HEAD_DIM, WINDOW, True)', ''),
    # the LRP reading the support before the SWAtten
    "lrp_unattended": (
        'torch.cat([mean_support, y0], dim=1)', 'torch.cat([torch.cat([lm] + support, dim=1), y0], dim=1)'),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The TINY tree, its TCM file at the TINY sizes and its mix 256x256."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    path = root / "benchmark" / "configs" / "tcm.json"
    conf = json.loads(path.read_text())
    conf["model"] = {k: v for k, v in conf["model"].items() if k not in ("division_dimension",)}
    conf["model"].update(TINY_TCM)
    path.write_text(json.dumps(conf))
    (root / "benchmark" / "traffic" / "clic2k_b1_q0.json").write_text(json.dumps(MIX))
    return root


def test_tcm_cell_correct_traced_and_untraced(root):
    out = tiny.run(root, CELL, seconds=1.0, trace=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    got = out["metrics"]
    assert got["tcm_host_ms"]["value"] > 0 and got["swatten_host_ms"]["value"] > 0
    # device readings need a card: none on the CPU
    assert not any(n in got for n in ("chain_mfu.tcm", "transforms_device_ms.tcm",
                                      "slice_nets_device_ms.tcm", "device_idle_share.tcm"))
    assert not any(n.endswith((".lat", ".tput", ".stf")) for n in got)
    plain = tiny.run(root, CELL, seconds=1.0)
    assert plain["correct"] and plain["failed"] == 0, plain["checks"]
    assert {"images_per_s", "bits_per_pixel", "setup_s"} == set(plain["metrics"])
    assert all(v[0] == 0 for k, v in plain["checks"].items() if k != "requests")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_reference_is_not_correct(root, tmp_path, fault):
    """The reference with a piece of TCM left out: the program no longer
    matches it."""
    import shutil

    faulty = tmp_path / "tree"
    shutil.copytree(root, faulty)
    path = faulty / "benchmark" / "reference" / "tcm.py"
    text = path.read_text()
    old, new = FAULTS[fault]
    assert text.count(old) == 1
    path.write_text(text.replace(old, new))
    out = tiny.run(faulty, CELL, seconds=0.5)
    assert not out["correct"]
    assert out["checks"]["xhat_rel_l2"][0] > out["checks"]["xhat_rel_l2"][1]


def test_file_sizes_checked():
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / "tcm.json").read_text())
    ref = harness.reference(tiny.REPO, conf)
    cfg = ref.Cfg(conf["model"])
    assert cfg.tcm == conf["model"]["tcm"] and cfg.N == 192 and cfg.width == 128
    conf["model"]["tcm"]["window_size"] = 4
    with pytest.raises(ValueError, match="tcm"):
        ref.Cfg(conf["model"])


def test_counts_at_the_cell_size_pinned():
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / "tcm.json").read_text())
    cfg = harness.reference(tiny.REPO, conf).Cfg(conf["model"])
    ref = yardstick.reference_of(cfg)
    assert ref.stage_sizes(cfg, 1, 1024, 2048, 0.0) == [192 * 16 * 32] + [64 * 64 * 128] * 5
    assert yardstick.chain_flops(cfg, 1, 1024, 2048, 0.0) == 8249239666688
    # a single-rate model: the quality changes nothing
    assert yardstick.chain_flops(cfg, 1, 1024, 2048, 10.0) == 8249239666688
    # four traced requests in one second on an H100: the whole step's share
    run = {"charged": {}, "profiled": [{"q": 0.0}] * 4, "busy_s": 0.9, "window_s": 1.0, "cfg": cfg,
           "batch": 1, "height": 1024, "width": 2048, "device_kind": "NVIDIA H100 80GB HBM3"}
    mfu = harness.metric_reader(tiny.REPO, "chain_mfu.tcm")(run)
    assert mfu == pytest.approx(100 * 4 * 8249239666688 / 66.9e12) and mfu < 100
