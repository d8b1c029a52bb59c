"""Phase breakdown of the granular codec's round trip.

Counterpart of tools/profile_codec.py.  The port names its own steps
(`utils/profiling.py`): each public codec call (`codec:*`), model fragment
(`frag:*`), coder phase (`coder:*`), step of the codec's own between them
(`glue:*`) and point where the host waits on the card (`sync:*`) is a span,
and a fragment that another fragment calls (`codec_base_step` runs
`codec_base_recon` and `codec_base_params`) is a child span of its
caller.  Each phase's own time is its span's less its children's.  The
spans change no computation, so the containers equal those of a codec run
without them byte for byte.

`main` profiles a model with seeded weights (`init_params`, seed 0; the
flagship `ModelConfig()` unless `--config` names a ModelConfig JSON file)
on one seeded image (`--size`, default 768x512): compress -> serialize ->
deserialize -> decompress at `--quality`.  A warm-up round trip first
checks the container made with the spans recorded against one made without
them, byte for byte, and every round trip must give stream_ok and the
y_hat of the encoder's simulate=True pass.  Two modes:
  * blocking (JAX's protocol): `--n` round trips under
    `profiling.recording(sync=True)`, a `torch.cuda.synchronize` at both
    ends of each span, host clock.  The sum exceeds an unprofiled round
    trip; read the shares.  `between_calls` is the time outside the codec's
    calls.
  * trace: one round trip under `utils/profiling.device_trace`, where every
    span is a profiler range.  Each kernel, copy and fill is charged to the
    innermost span whose range holds its launch.  The record gives the
    device-busy ms per phase and the idle share of the traced round trip,
    beside the median wall ms of `--n` untraced round trips (host clock
    around work that ends in a sync): the profiler's own cost is not small.
The record is printed as one JSON line, with the card's name and power
limit on the card.  On the CPU (`--device cpu`) the times are the host's,
under `host_*` names, and the trace mode measures no device time.

Usage:
    python -m progressivecodec_tpu_torch.tools.profile_codec [--mode blocking|trace]
        [--lanes 512] [--n 4] [--quality 10] [--size 768x512] [--config cfg.json]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.utils import profiling

BETWEEN = "between_calls"
GLUE = "glue"
ROUND_TRIP = "round_trip"
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_EVENTS = ("user_annotation", "cpu_op")  # record_function's ranges, the port's spans
LAUNCH_EVENTS = ("cuda_runtime", "cuda_driver")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spans_since(t0_ns: int) -> list:
    """The recorded spans opened at or after `t0_ns`."""
    return [s for s in profiling.spans() if s.t0_ns >= t0_ns]


def attribute_device_time(trace: dict, names, outer: str = ROUND_TRIP):
    """Charge each device event (kernel, copy, fill) of a torch.profiler
    Chrome trace to the innermost range among `names` and `outer` that
    holds its launch (the runtime call of the same correlation id, on the
    same thread); an event whose innermost range is `outer` is `glue`, one
    launched outside `outer` is not counted.  Returns ({phase: (device ms,
    events)}, busy ms: the union of the counted events' intervals)."""
    names = set(names) | {outer}
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid"), e["name"]) for e in events
              if e.get("cat") in RANGE_EVENTS and e.get("name") in names]
    launches = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_EVENTS and "correlation" in e.get("args", {})}
    per: dict = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in events:
        if e.get("cat") not in DEVICE_EVENTS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t, tid = launch
        holding = [r for r in ranges if r[2] == tid and r[0] <= t <= r[1]]
        if not holding:
            continue
        inner = max(holding, key=lambda r: r[0])[3]  # the latest start: the innermost
        cell = per[GLUE if inner == outer else inner]
        cell[0] += e["dur"] / 1e3
        cell[1] += 1
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {k: (v[0], v[1]) for k, v in per.items()}, busy / 1e3


def round_trip(codec, x, quality: float, ref_y_hat: torch.Tensor) -> int:
    """compress -> serialize -> deserialize -> decompress, checked; the
    container's bytes."""
    blob = codec.serialize(codec.compress(x, quality=quality))
    out = codec.decompress(codec.deserialize(blob))
    if not out["stream_ok"]:
        raise RuntimeError(f"q={quality}: stream_ok is False")
    if not torch.equal(out["y_hat"], ref_y_hat):
        raise RuntimeError(f"q={quality}: decoded y_hat != the encoder's simulated y_hat")
    return len(blob)


def seeded_image(h: int, w: int, seed: int = 1, batch: int = 1) -> np.ndarray:
    """A (batch, h, w, 3) float32 batch of images, uniform in [0, 1) (JAX's
    tool draws jax.random.uniform)."""
    return np.random.default_rng(seed).random((batch, h, w, 3)).astype(np.float32)


def _table(rows: dict, key: str) -> str:
    lines = [f"{'phase':34s} {key:>12s} {'share':>7s} {'calls':>7s}"]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1][key]):
        lines.append(f"{name:34s} {r[key]:12.3f} {100 * r['share']:6.1f}% {r['calls']:7g}")
    return "\n".join(lines)


def profile(codec: GranularCodec, x: torch.Tensor, quality: float, n: int, mode: str) -> dict:
    """The record of `n` round trips (blocking) or of one traced round trip
    beside `n` untraced ones (trace), after a checked warm-up."""
    if mode not in ("blocking", "trace"):
        raise ValueError(f"mode {mode!r}")
    dev = codec.device
    data = codec.compress(x, quality=quality, simulate=True)
    ref = data["y_hat"]
    with profiling.recording():
        blob = codec.serialize(codec.compress(x, quality=quality))
    if blob != codec.serialize(codec.compress(x, quality=quality)):
        raise RuntimeError("the container made with spans recorded differs from the plain one")
    n_bytes = round_trip(codec, x, quality, ref)
    card = dev.type == "cuda"
    pre = "" if card else "host_"  # the CPU's times are the host's
    rec = {"tool": "profile_codec", "mode": mode,
           "device": torch.cuda.get_device_name(dev) if card else "cpu",
           "model": codec.cfg.name, "size": list(x.shape[1:3]), "quality": quality,
           "lanes": codec.lanes, "groups": codec.groups, "n": n, "bytes": n_bytes,
           "stream_ok": True, "y_hat_exact": True, "containers_equal_plain": True}
    if card:
        rec["nvidia_smi"] = card_line()

    if mode == "blocking":
        _sync(dev)
        t_ns = time.time_ns()
        t0 = time.perf_counter()
        with profiling.recording(sync=True):
            for _ in range(n):
                round_trip(codec, x, quality, ref)
        _sync(dev)
        total = time.perf_counter() - t0
        recs = spans_since(t_ns)
        selfs = profiling.self_ns(recs)
        own = defaultdict(float)
        for s in recs:
            own[s.name] += selfs[s.id] * 1e-9
        own[BETWEEN] = total - sum(own.values())
        calls = Counter(s.name for s in recs)
        rows = {k: {"calls": calls.get(k, 0) / n, f"{pre}ms": 1e3 * v / n, "share": v / total}
                for k, v in own.items()}
        rec.update({f"{pre}round_trip_ms": 1e3 * total / n, "phases": rows})
        print(_table(rows, f"{pre}ms"), flush=True)
        return rec

    walls = []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        round_trip(codec, x, quality, ref)
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            _sync(dev)
            t_ns = time.time_ns()
            t0 = time.perf_counter()
            with torch.profiler.record_function(ROUND_TRIP):
                round_trip(codec, x, quality, ref)
            _sync(dev)
            traced_ms = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
            trace = json.load(f)
    calls = Counter(s.name for s in spans_since(t_ns))
    rec.update({f"{pre}untraced_round_trip_ms": statistics.median(walls),
                f"{pre}traced_round_trip_ms": traced_ms})
    if not card:
        rec["device_time"] = "not measured: no card"
        rec["phases"] = {k: {"calls": v} for k, v in calls.items()}
        return rec
    per, busy = attribute_device_time(trace, list(calls))
    rows = {k: {"calls": calls.get(k, 0), "device_ms": ms, "events": ev,
                "share": ms / sum(v[0] for v in per.values())} for k, (ms, ev) in per.items()}
    for k, c in calls.items():  # phases that launched nothing on the card
        rows.setdefault(k, {"calls": c, "device_ms": 0.0, "events": 0, "share": 0.0})
    rec.update({"device_busy_ms": busy, "device_events": sum(v[1] for v in per.values()),
                "device_events_in_trace": sum(e.get("cat") in DEVICE_EVENTS
                                              for e in trace["traceEvents"]),
                "idle_share_traced": 1.0 - busy / traced_ms,
                "idle_share_untraced": 1.0 - busy / statistics.median(walls),
                "phases": rows})
    print(_table(rows, "device_ms"), flush=True)
    return rec


def model_config(path: str | None) -> ModelConfig:
    """The ModelConfig of a JSON file, or the flagship `ModelConfig()`."""
    if path is None:
        return ModelConfig()
    with open(path) as f:
        return config_lib.model_config_from_json(f.read())


def seeded_model(cfg: ModelConfig, device, seed: int = 0):
    """The model of `cfg` on `device` with `init_params` weights of `seed`."""
    model = get_model(cfg, device=device)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)), strict=True)
    return model


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("blocking", "trace"), default="blocking")
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--quality", type=float, default=10.0)
    p.add_argument("--size", type=str, default="768x512", help="WIDTHxHEIGHT")
    p.add_argument("--config", type=str, default=None, help="ModelConfig JSON file")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    codec = GranularCodec(seeded_model(model_config(args.config), dev), lanes=args.lanes, device=dev)
    codec.update()
    w, h = (int(v) for v in args.size.split("x"))
    rec = profile(codec, torch.from_numpy(seeded_image(h, w)).to(dev), args.quality, args.n,
                  args.mode)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
