"""Configurations, traffic mixes and per-layer metrics are found by name: a
fifth cell with a configuration, a mix and a metric of its own runs from new
files and new entries alone."""

import json

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
