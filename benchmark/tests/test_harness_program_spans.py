"""The per-layer metrics read from the program's own spans and counters:
a TINY traced run on the CPU reports the host-time and escape metrics and,
without device intervals, no unnamed-idle share; `_spans.idle_split` on
synthetic spans and intervals; and the program's spans move no operation
between the groups the device-time readers charge (transforms, slice
networks, coder phases), with the recorder on and off."""

from __future__ import annotations

import importlib
from collections import Counter
from types import SimpleNamespace

import torch

from benchmark import harness, trace
from benchmark.metrics import _spans
from benchmark.tests import tiny


def test_traced_run_reports_the_program_span_metrics(tmp_path):
    root = tiny.make_root(tmp_path)
    for cell in ("flagship.kodak_b1_finegrid", "rem.kodak_b1_finegrid"):
        out = tiny.run(root, cell, seconds=1.0, trace=True)
        assert out["correct"], out["checks"]
        got = out["metrics"]
        for name in ("coder_host_ms.lat", "slice_nets_host_ms.lat", "sync_wait_ms.lat",
                     "escape_share"):
            assert name in got and got[name]["value"] > 0, (cell, name, got.get(name))
        assert got["escape_share"]["value"] < 100
        assert "idle_unnamed_share.lat" not in got
        assert not any(n.endswith(".tput") for n in got)


def _span(i, name, t0, t1, parent=None):
    return SimpleNamespace(id=i, parent=parent, name=name, t0_ns=t0, t1_ns=t1, counts={})


def test_idle_split_on_synthetic_spans():
    spans = [_span(1, "codec:compress", 0, 100),
             _span(2, "frag:x", 5, 30, 1), _span(3, "sync:y", 25, 28, 2),
             _span(4, "glue:z", 70, 80, 1),
             _span(5, "codec:compress_from_latent", 85, 95, 1), _span(6, "coder:p", 88, 90, 5)]
    # idle in the requests: [0, 10], [20, 50], [60, 100] and the whole of [200, 210]
    idle, unnamed = _spans.idle_split([(0, 100), (200, 210)], [[10, 20], [50, 60]], spans)
    assert idle == 80 + 10
    # named: [5, 30] (frag:x and its sync), [70, 80], [88, 90]
    assert unnamed == 5 + 20 + 10 + 8 + 10 + 10
    assert _spans.self_ns(spans)[2] == 22 and _spans.self_ns(spans)[1] == 100 - 25 - 10 - 10
    assert [s.id for s in _spans.outermost(spans, "frag:")] == [2]
    assert {s.id for s in _spans.descendants(spans, spans[0])} == {2, 3, 4, 5, 6}


def _groups_of_ops(prog, conf, x, q) -> Counter:
    """Operators of one traced request by the group of the innermost range
    that the benchmark charges holding each (the device-time readers'
    attribution, with each operator standing for the launches it makes)."""
    frags, phases = conf["fragments"], conf["coder_phases"] + conf["scan_phases"]
    group = {f"frag:{n}": g for g, names in frags.items() for n in names}
    group.update({f"coder:{n}": "coder" for n in phases})
    with trace.spans(prog.model, prog.coder_module, frags["transforms"] + frags["slice_nets"],
                     phases):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(trace.REQUEST):
                prog.request(x, q)
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
              if e.name() in group or e.name() == trace.REQUEST]
    out = Counter()
    for e in events:
        if e.name().startswith("aten::"):
            holding = [r for r in ranges if r[0] <= e.start_ns() <= r[1]]
            inner = max(holding, key=lambda r: r[0])[2] if holding else None
            out[group.get(inner, "glue")] += 1
    return out


def test_device_readings_unmoved_by_native_spans(tmp_path, monkeypatch):
    profiling = importlib.import_module("progressivecodec_tpu_torch.utils.profiling")
    root = tiny.make_root(tmp_path)
    torch.set_num_threads(2)
    for config in ("flagship", "rem"):
        conf = tiny.tiny_conf(root, config)
        prog = harness.Program(conf, torch.device("cpu"), lambda m: None)
        x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
        prog.request(x, 4.2)
        n0 = len(profiling.spans())
        with_spans = _groups_of_ops(prog, conf, x, 4.2)
        assert len(profiling.spans()) > n0
        with monkeypatch.context() as m:
            m.setattr(profiling, "_profiler_enabled", lambda: False)
            n1 = len(profiling.spans())
            without = _groups_of_ops(prog, conf, x, 4.2)
            assert len(profiling.spans()) == n1
        assert with_spans == without and with_spans["slice_nets"] > 0, (with_spans, without)
        assert with_spans["transforms"] > 0 and with_spans["coder"] > 0
