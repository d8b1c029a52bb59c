"""Spans around the program's layers, and the device time charged to them.

A frozen copy of `progressivecodec_tpu_torch/tools/profile_codec.py`
(`ProfiledCodec._wrapped`, `attribute_device_time`): while a traced request
runs, each model fragment named in the configuration file (`frag:<name>`)
and each coder phase (`coder:<name>`) runs inside a
`torch.profiler.record_function` range; a fragment called by another
fragment is part of its caller.  Every kernel, copy and fill of the trace
is charged to the innermost range that holds its launch (the runtime call
of the same CUDA correlation id, on the same thread).  The events stay in
memory: nothing is written.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

REQUEST = "request"
GLUE = "glue"


@contextlib.contextmanager
def spans(model, coder_module, fragments, coder_phases):
    """Fragment and coder-phase ranges on the model instance and the coder
    module while the block runs."""
    inside = [False]

    def fragment(name, fn):
        def run(*args, **kwargs):
            if inside[0]:
                return fn(*args, **kwargs)
            inside[0] = True
            try:
                with torch.profiler.record_function(f"frag:{name}"):
                    return fn(*args, **kwargs)
            finally:
                inside[0] = False
        return run

    def phase(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(f"coder:{name}"):
                return fn(*args, **kwargs)
        return run

    frags = [n for n in fragments if hasattr(model, n)]
    phases = {n: getattr(coder_module, n) for n in coder_phases if hasattr(coder_module, n)}
    for n in frags:
        setattr(model, n, fragment(n, getattr(model, n)))
    for n, fn in phases.items():
        setattr(coder_module, n, phase(n, fn))
    try:
        yield
    finally:
        for n in frags:
            delattr(model, n)
        for n, fn in phases.items():
            setattr(coder_module, n, fn)


def charge(events, range_names) -> dict:
    """Kineto events of a profile -> {"per": {range: [device s, events]},
    "kernels": {kernel name: device s}, "busy_s", "intervals": merged device
    [start, end] ns, "ranges": [(start, end, name)] host ranges}.  Host
    ranges are the record_function events named in `range_names`; launches
    are the host's CUDA runtime and driver calls; device events are those on
    the card.  The request loop runs on one thread, so a launch is placed by
    its time alone."""
    ranges, launches, device = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if name not in range_names:  # the profiler mirrors host ranges on the device
                device.append(e)
        elif name in range_names:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name.startswith(("cuda", "cu")) and e.correlation_id() > 0:
            launches[e.correlation_id()] = e.start_ns()
    per: dict = defaultdict(lambda: [0.0, 0])
    kernels: dict = defaultdict(float)
    spans_ns, unlinked = [], 0
    for e in device:
        dur = e.duration_ns() * 1e-9
        spans_ns.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        kernels[e.name()] += dur
        t = launches.get(e.correlation_id())
        if t is None:
            unlinked += 1
            continue
        holding = [r for r in ranges if r[0] <= t <= r[1]]
        if not holding:
            continue
        inner = max(holding, key=lambda r: r[0])[2]
        cell = per[GLUE if inner == REQUEST else inner]
        cell[0] += dur
        cell[1] += 1
    busy, merged = 0, []
    for a, b in sorted(spans_ns):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                busy += b - merged[-1][1]
                merged[-1][1] = b
        else:
            busy += b - a
            merged.append([a, b])
    return {"per": dict(per), "kernels": dict(kernels), "busy_s": busy * 1e-9,
            "intervals": merged, "ranges": ranges, "device_events": len(device),
            "launches": len(launches), "unlinked": unlinked}


def idle_gaps(charged: dict, t0_ns: int, t1_ns: int, top: int = 10) -> list:
    """The longest gaps without device work inside [t0, t1], each named by
    the innermost host range open at the gap's middle."""
    gaps, prev = [], t0_ns
    for a, b in charged["intervals"] + [[t1_ns, t1_ns]]:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    named: dict = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        holding = [r for r in charged["ranges"] if r[0] <= mid <= r[1]]
        name = max(holding, key=lambda r: r[0])[2] if holding else "between requests"
        named[GLUE if name == REQUEST else name] += (b - a) * 1e-9
    return sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])[:top]
