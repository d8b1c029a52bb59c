"""Configurations, their plain references, traffic mixes and per-layer
metrics are found by name: a fifth cell with a configuration, a mix and a
metric of its own, and a new architecture with a reference of its own, run
from new files and new entries alone."""

import json
import sys
import textwrap

from benchmark import harness
from benchmark.tests import tiny


def test_files_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    bench, cell, conf, mix = harness.load_cell(root, "rem.kodak_b1_finegrid")
    assert cell["config"] == "rem" and conf["model"]["name"] == "rate"
    assert mix["batch"] == 1
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(root, m["name"]))


def test_a_fifth_cell_takes_new_files_only(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    conf = tiny.tiny_conf(root, "flagship")
    conf["codec"]["lanes"] = 32
    (root / "benchmark" / "configs" / "narrow_lanes.json").write_text(json.dumps(conf))
    (root / "benchmark" / "traffic" / "two_qualities.json").write_text(json.dumps(
        {"height": 64, "width": 128, "batch": 1, "qualities": [2.5, 10.0], "pool": 2, "pool_seed": 9,
         "warmup_qualities": [10.0], "profiled_requests": 1, "check_requests": 2, "check_span": 2}))
    (root / "benchmark" / "metrics" / "requests_in_window.py").write_text(
        "def read(run):\n    return float(len(run['requests'])) if run['requests'] else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "narrow_lanes", "source": "https://example.org/narrow",
                             "file": "benchmark/configs/narrow_lanes.json", "reduced": [],
                             "why": "the flagship's codec on 32 lanes"})
    bench["workloads"].append({"name": "narrow_lanes.two_qualities", "config": "narrow_lanes",
                               "traffic": "two_qualities", "chips": 1, "why": "a fifth cell"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "codec entry", "moves": "images_per_s",
                               "workloads": ["narrow_lanes.two_qualities"]})
    for m in bench["end_to_end"]:  # a metric kept to some cells lists the new one too
        if m["name"] == "images_per_s":
            m["workloads"].append("narrow_lanes.two_qualities")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny.run(root, "narrow_lanes.two_qualities", seconds=1.0, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_in_window"]["value"] >= 1
    plain = tiny.run(root, "narrow_lanes.two_qualities", seconds=1.0)
    assert {"images_per_s", "bits_per_pixel", "setup_s"} <= set(plain["metrics"])
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


# a reference of its own: the flagship's, every bias drawn by a kind it declares
ARCH = textwrap.dedent("""

    INIT_KINDS = {"arch_bias": {"const": 0.01}}
    _flagship_spec = param_spec


    def param_spec(cfg):
        return [(n, s, "arch_bias" if k == "bias" else k) for n, s, k in _flagship_spec(cfg)]
""")
# the same, with the reconstruction it expects scaled by 0.98
SCALED = textwrap.dedent("""

    _unscaled_request = reference_request


    def reference_request(P, cfg, x, quality, medians=None):
        out = _unscaled_request(P, cfg, x, quality, medians)
        return dict(out, x_hat=out["x_hat"] * 0.98)
""")


def test_a_new_architecture_takes_new_files_only(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    old_bench = json.loads((root / "BENCHMARK.json").read_text())
    refs = root / "benchmark" / "reference"
    (refs / "arch.py").write_text((refs / "model.py").read_text() + ARCH)
    (refs / "arch_scaled.py").write_text((refs / "model.py").read_text() + ARCH + SCALED)
    conf = tiny.tiny_conf(root, "flagship")
    conf["reference"] = "arch"
    conf_path = root / "benchmark" / "configs" / "arch.json"
    conf_path.write_text(json.dumps(conf))
    (root / "benchmark" / "traffic" / "arch_mix.json").write_text(json.dumps(
        {"height": 64, "width": 128, "batch": 1, "qualities": [0.0, 4.4, 10.0], "pool": 2, "pool_seed": 3,
         "warmup_qualities": [10.0], "profiled_requests": 1, "check_requests": 3, "check_span": 3}))
    (root / "benchmark" / "metrics" / "stages_at_top.py").write_text(
        "def read(run):\n"
        "    from benchmark import yardstick\n"
        "    ref, c = yardstick.reference_of(run['cfg']), run['cfg']\n"
        "    return float(len(ref.stage_sizes(c, run['batch'], run['height'], run['width'], 10.0)))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "arch", "source": "https://example.org/arch",
                             "file": "benchmark/configs/arch.json", "reduced": [],
                             "why": "an architecture with a reference of its own"})
    bench["workloads"].append({"name": "arch.mix", "config": "arch", "traffic": "arch_mix", "chips": 1,
                               "why": "a new architecture"})
    bench["per_layer"].append({"name": "stages_at_top", "unit": "stages", "better": "lower",
                               "source": "host_clock", "layer": "coder", "moves": "bits_per_pixel",
                               "workloads": ["arch.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = tiny.run(root, "arch.mix", seconds=1.0, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["stages_at_top"]["value"] == 6  # z, 4 base slices, the stacked enhancement
    arch = sys.modules["benchmark_reference_arch"]
    assert arch.__file__ == str(refs / "arch.py") and arch.INIT_KINDS["arch_bias"]["const"] == 0.01
    plain = tiny.run(root, "arch.mix", seconds=1.0)
    assert {"bits_per_pixel", "setup_s"} <= set(plain["metrics"]) and plain["correct"]

    # the run uses the reference the configuration names, and no other
    conf["reference"] = "arch_scaled"
    conf_path.write_text(json.dumps(conf))
    out = tiny.run(root, "arch.mix", seconds=1.0)
    assert not out["correct"]
    assert out["checks"]["xhat_rel_l2"][0] > out["checks"]["xhat_rel_l2"][1]
    assert out["checks"]["bytes_gap"][0] == 0

    # nothing that was there changed; BENCHMARK.json only gained entries
    assert all(p.read_bytes() == b for p, b in before.items() if p.name != "BENCHMARK.json")
    for key, old in old_bench.items():
        assert bench[key][: len(old)] == old if isinstance(old, list) else bench[key] == old
