"""The STF cell from its own files: the TINY STF (N 32, M 64) runs correct,
traced and untraced, with the Swin span metric; a synthesis block that
leaves out its shift comes out not correct; the file's Swin sizes are those
of N and M; the reference's stages and FLOPs at the cell's 2048x1024 are
pinned."""

import json

import pytest

from benchmark import harness, yardstick
from benchmark.tests import tiny

CELL = "stf.clic2k_b1_q0"


def _conf(root):
    return json.loads((root / "benchmark" / "configs" / "stf.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The TINY tree, its STF file's "swin" entry made the TINY sizes."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    conf = _conf(root)
    model = {k: v for k, v in conf["model"].items() if k != "swin"}
    conf["model"]["swin"] = harness.reference(root, conf).Cfg(model).swin
    (root / "benchmark" / "configs" / "stf.json").write_text(json.dumps(conf))
    return root


def test_stf_cell_correct_traced_and_untraced(root):
    out = tiny.run(root, CELL, seconds=1.0, trace=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    got = out["metrics"]
    assert got["swin_host_ms"]["value"] > 0
    # device readings need a card: none on the CPU
    assert "chain_mfu.stf" not in got and "transforms_device_ms.stf" not in got
    assert not any(n.endswith((".lat", ".tput")) for n in got)
    plain = tiny.run(root, CELL, seconds=1.0)
    assert plain["correct"] and plain["failed"] == 0, plain["checks"]
    assert {"images_per_s", "bits_per_pixel", "setup_s"} == set(plain["metrics"])
    assert all(v[0] == 0 for k, v in plain["checks"].items() if k != "requests")


def test_unshifted_synthesis_block_is_not_correct(root):
    """The first synthesis stage's shifted block on plain windows.  (At TINY
    the same fault in a later stage reads xhat_rel_l2 2.7-4.9e-4, under the
    limit: at Swin's 0.02 init the attention adds little to the residual.)"""

    class Unshifted(harness.Program):
        def __init__(self, *a):
            super().__init__(*a)
            self.model.syn_layers[0].blocks[1].shift_size = 0

    out = tiny.run(root, CELL, seconds=1.0, program_factory=Unshifted)
    assert not out["correct"]
    assert out["checks"]["xhat_rel_l2"][0] > out["checks"]["xhat_rel_l2"][1]
    assert out["checks"]["bytes_gap"][0] == 0  # the synthesis runs after the container


def test_file_sizes_checked_against_n_and_m(root):
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / "stf.json").read_text())
    ref = harness.reference(tiny.REPO, conf)
    assert ref.Cfg(conf["model"]).swin == conf["model"]["swin"]
    conf["model"].update(tiny.TINY_MODEL)
    with pytest.raises(ValueError, match="swin"):
        ref.Cfg(conf["model"])


def test_counts_at_the_cell_size_pinned():
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / "stf.json").read_text())
    cfg = harness.reference(tiny.REPO, conf).Cfg(conf["model"])
    ref = yardstick.reference_of(cfg)
    assert ref.stage_sizes(cfg, 1, 1024, 2048, 0.0) == [192 * 16 * 32] + [32 * 64 * 128] * 12
    assert yardstick.chain_flops(cfg, 1, 1024, 2048, 0.0) == 3252717355008
    # a single-rate model: the quality changes nothing
    assert yardstick.chain_flops(cfg, 1, 1024, 2048, 10.0) == 3252717355008
    # four traced requests in one second on an H100: the whole step's share
    run = {"charged": {}, "profiled": [{"q": 0.0}] * 4, "busy_s": 0.5, "window_s": 1.0, "cfg": cfg,
           "batch": 1, "height": 1024, "width": 2048, "device_kind": "NVIDIA H100 80GB HBM3"}
    mfu = harness.metric_reader(tiny.REPO, "chain_mfu.stf")(run)
    assert mfu == pytest.approx(100 * 4 * 3252717355008 / 66.9e12) and mfu < 100
