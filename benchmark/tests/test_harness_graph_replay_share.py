"""`graph_replay_share`, read from the program's `graph:*` counters: None
for a program without the recorder or without the counters, the share of
replays from a synthetic counter set, and, in a TINY traced REM run on the
CPU, 0% with the program's own CUDA backend (no graph on the CPU) and 100%
with a capture backend injected that emulates the graphs there."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.tests import tiny

READER = importlib.import_module("benchmark.metrics.graph_replay_share")


def _span(i, t0, t1, counts):
    return SimpleNamespace(id=i, parent=None, name="frag:codec_prog_params", t0_ns=t0, t1_ns=t1,
                           counts=counts)


def _run():
    return {"charged": {"ranges": [(0, 100, "request"), (200, 300, "request")]},
            "profiled": [{}, {}], "batch": 1}


def test_share_from_synthetic_counters(monkeypatch):
    profiling = importlib.import_module("progressivecodec_tpu_torch.utils.profiling")
    spans = [_span(1, 10, 20, {"graph:replay": 30}), _span(2, 210, 220, {"graph:replay": 29}),
             _span(3, 230, 240, {"graph:eager": 1, "graph:capture": 50}),
             _span(4, 400, 410, {"graph:eager": 1000})]  # outside the traced requests
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert READER.read(_run()) == pytest.approx(100.0 * 59 / 60)
    monkeypatch.setattr(profiling, "spans", lambda: [_span(1, 10, 20, {"words:payload": 9})])
    assert READER.read(_run()) is None


def test_none_without_the_recorder(monkeypatch):
    profiling = importlib.import_module("progressivecodec_tpu_torch.utils.profiling")
    monkeypatch.delattr(profiling, "spans")
    assert _spans.traced(_run()) is None and READER.read(_run()) is None
    assert READER.read({"charged": {"ranges": []}}) is None


class _Emulated:
    """A capture backend for the CPU: a "graph" reruns its unit on the
    captured arguments and copies the results into the captured outputs."""

    def supports(self, device):
        return True

    def pool(self):
        return None

    def capture(self, fn, args, pool):
        from progressivecodec_tpu_torch.models import graphs

        out = fn(*args)

        def replay():
            for o, n in zip(graphs._leaves((out,), []), graphs._leaves((fn(*args),), [])):
                o.copy_(n)

        return replay, out


def test_traced_rem_run_reads_the_share(tmp_path):
    root = tiny.make_root(tmp_path, qualities=(3.7, 0.2, 10.0))

    def emulated(conf, dev, log, ref):
        prog = harness.Program(conf, dev, log, ref)
        prog.codec.graphs.backend = _Emulated()
        return prog

    for factory, want in ((harness.Program, 0.0), (emulated, 100.0)):
        out = tiny.run(root, "rem.kodak_b1_finegrid", seconds=1.0, trace=True,
                       program_factory=factory)
        assert out["correct"], out["checks"]
        assert out["metrics"]["graph_replay_share.lat"]["value"] == want
    out = tiny.run(root, "flagship.kodak_b1_finegrid", seconds=1.0, trace=True)
    assert "graph_replay_share.lat" not in out["metrics"]
