"""BENCHMARK.json keeps the benchmark contract's shape, and a run's result
has the keys a result line must carry, with the compared numbers last."""

import json
import re
import subprocess
import sys

import pytest

from benchmark.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (tiny.REPO / c["file"]).exists()
        assert c["reduced"] == [] and _line(c["source"]) and _line(c["why"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and _line(w["why"])
        assert (tiny.REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        names.append(w["name"])
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    e2e = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
        names.append(m["name"])
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.fullmatch(n) for n in names) and len(set(names)) == len(names)
    for w in cells:  # setup_s, one more end-to-end metric and a per-layer metric in every cell
        reported = [m for m in BENCH["end_to_end"] if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_result_keys(tmp_path):
    root = tiny.make_root(tmp_path)
    out = tiny.run(root, "flagship.kodak_b1_finegrid", seconds=1.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for k, v in out["checks"].items():
        if k != "requests":
            assert len(v) == 2 and v[0] <= v[1]
    traced = tiny.run(root, "flagship.kodak_b1_finegrid", seconds=1.0, trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "flagship.kodak_b1_finegrid",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    if r.returncode == 0:
        pytest.skip("a card is present")
    assert r.returncode == 2 and r.stdout == ""
