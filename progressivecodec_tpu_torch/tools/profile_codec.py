"""Phase breakdown of the granular codec's round trip.

Counterpart of tools/profile_codec.py.  `ProfiledCodec` runs each model
fragment (`frag:<name>`) and each flat phase and scan of
`coder/rans_device.py` (`coder:<name>`) of its `compress` and `decompress`,
and its `serialize` and `deserialize` (`container:*`), inside a named phase;
the rest of the round trip is `glue` (z quantisation, symbol rounding,
`torch.cat`, the host's own work).  A fragment that another fragment calls (`codec_base_step` runs
`codec_base_recon` and `codec_base_params`) is part of its caller, as JAX's
fused fragment is.  A phase that holds another (`encode_stages_grouped`
runs the encode's prepare and scan) keeps only its own time.  The wrappers
call the same functions on the same tensors, so the containers equal a
plain `GranularCodec`'s byte for byte.

`main` profiles a model with seeded weights (`init_params`, seed 0; the
flagship `ModelConfig()` unless `--config` names a ModelConfig JSON file)
on one seeded image (`--size`, default 768x512): compress -> serialize ->
deserialize -> decompress at `--quality`.  A warm-up round trip first
checks the profiled container against a plain codec's, byte for byte, and
every round trip must give stream_ok and the y_hat of the encoder's
simulate=True pass.  Two modes:
  * blocking (JAX's protocol): `torch.cuda.synchronize` at both ends of each
    phase, host clock, `--n` round trips.  The sum exceeds an unprofiled
    round trip; read the shares.
  * trace: one round trip under `utils/profiling.device_trace`, each phase a
    `torch.profiler.record_function` range.  Each kernel, copy and fill is
    charged to the innermost phase whose range holds its launch.  The record
    gives the device-busy ms per phase and the idle share of the traced
    round trip, beside the median wall ms of `--n` untraced round trips
    (host clock around work that ends in a sync): the profiler's own cost
    is not small.
JAX times its jitted dispatches (`_call`, `_J_*`); the port has no
dispatch table, so its fragments, direct calls, are wrapped by name.  The
record is printed as one JSON line, with the card's name and power limit
on the card.  On the CPU (`--device cpu`) the times are the host's, under
`host_*` names, and the trace mode measures no device time.

Usage:
    python -m progressivecodec_tpu_torch.tools.profile_codec [--mode blocking|trace]
        [--lanes 512] [--n 4] [--quality 10] [--size 768x512] [--config cfg.json]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.coder import rans_device
from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.utils.profiling import TRACE_FILE, device_trace

FRAGMENTS = (
    "analyze", "codec_hyper_enc", "codec_hyper_dec", "codec_base_params", "codec_base_step",
    "codec_base_recon", "codec_prog_stacked", "codec_prog_recon_stacked", "codec_prog_params",
    "codec_prog_recon", "codec_synth",
)
CODER = (
    "encode_prepare", "encode_scan_rev", "encode_finalize", "encode_stages_grouped",
    "decoder_init", "decode_stage_scan", "decode_stage_values", "grouped_decoder_init",
    "decode_stage_grouped_scan", "decode_stage_grouped_values",
)
GLUE = "glue"
ROUND_TRIP = "round_trip"
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_EVENTS = ("cuda_runtime", "cuda_driver")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Phases:
    """Calls and own time per named phase.  blocking: host clock between
    device syncs at both ends, less the phases inside; trace: a
    `record_function` range, the time read from the trace afterwards."""

    def __init__(self, mode: str, device: torch.device):
        if mode not in ("blocking", "trace"):
            raise ValueError(f"mode {mode!r}")
        self.mode, self.device = mode, device
        self.calls: dict = defaultdict(int)
        self.own_s: dict = defaultdict(float)
        self._inner: list = []  # time of the phases inside each open blocking span

    def reset(self) -> None:
        self.calls.clear()
        self.own_s.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        self.calls[name] += 1
        if self.mode == "trace":
            with torch.profiler.record_function(name):
                yield
            return
        _sync(self.device)
        self._inner.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            dt = time.perf_counter() - t0
            self.own_s[name] += dt - self._inner.pop()
            if self._inner:
                self._inner[-1] += dt


class ProfiledCodec(GranularCodec):
    """GranularCodec whose fragments, coder phases and container run inside
    the named phases of `self.phases` (mode "blocking" or "trace")."""

    def __init__(self, model, *args, mode: str = "blocking", **kwargs):
        super().__init__(model, *args, **kwargs)
        self.phases = Phases(mode, self.device)
        self._in_fragment = False

    def _fragment(self, name, fn):
        def run(*args, **kwargs):
            if self._in_fragment:  # called by another fragment: part of it
                return fn(*args, **kwargs)
            self._in_fragment = True
            try:
                with self.phases.span(f"frag:{name}"):
                    return fn(*args, **kwargs)
            finally:
                self._in_fragment = False
        return run

    def _coder(self, name, fn):
        def run(*args, **kwargs):
            with self.phases.span(f"coder:{name}"):
                return fn(*args, **kwargs)
        return run

    @contextlib.contextmanager
    def _wrapped(self):
        """The fragment wrappers on the model instance and the coder
        wrappers on `rans_device`, while one public call runs."""
        m = self.model
        frags = [n for n in FRAGMENTS if hasattr(m, n)]
        coder = {n: getattr(rans_device, n) for n in CODER}
        for n in frags:
            setattr(m, n, self._fragment(n, getattr(m, n)))
        for n, fn in coder.items():
            setattr(rans_device, n, self._coder(n, fn))
        try:
            yield
        finally:
            for n in frags:
                delattr(m, n)
            for n, fn in coder.items():
                setattr(rans_device, n, fn)

    def compress(self, *args, **kwargs):
        with self._wrapped():
            return super().compress(*args, **kwargs)

    def decompress(self, *args, **kwargs):
        with self._wrapped():
            return super().decompress(*args, **kwargs)

    def serialize(self, data):
        with self.phases.span("container:serialize"):
            return super().serialize(data)

    def deserialize(self, blob):
        with self.phases.span("container:deserialize"):
            return super().deserialize(blob)


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
              if e.get("cat") == "user_annotation" and e.get("name") in names]
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


def profile(codec: ProfiledCodec, x: torch.Tensor, quality: float, n: int) -> dict:
    """The record of `n` round trips (blocking) or of one traced round trip
    beside `n` untraced ones (trace), after a checked warm-up."""
    dev, phases = codec.device, codec.phases
    data = codec.compress(x, quality=quality, simulate=True)
    ref = data["y_hat"]
    plain = GranularCodec(codec.model, lanes=codec.lanes, groups=codec.groups,
                          lane_policy=codec.lane_policy, device=dev)
    blob = codec.serialize(codec.compress(x, quality=quality))
    if blob != plain.serialize(plain.compress(x, quality=quality)):
        raise RuntimeError("the profiled codec's container differs from the plain codec's")
    n_bytes = round_trip(codec, x, quality, ref)
    card = dev.type == "cuda"
    pre = "" if card else "host_"  # the CPU's times are the host's
    rec = {"tool": "profile_codec", "mode": phases.mode,
           "device": torch.cuda.get_device_name(dev) if card else "cpu",
           "model": codec.cfg.name, "size": list(x.shape[1:3]), "quality": quality,
           "lanes": codec.lanes, "groups": codec.groups, "n": n, "bytes": n_bytes,
           "stream_ok": True, "y_hat_exact": True, "containers_equal_plain": True}
    if card:
        rec["nvidia_smi"] = card_line()

    if phases.mode == "blocking":
        phases.reset()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            round_trip(codec, x, quality, ref)
        _sync(dev)
        total = time.perf_counter() - t0
        own = dict(phases.own_s)
        own[GLUE] = total - sum(own.values())
        rows = {k: {"calls": phases.calls.get(k, 0) / n, f"{pre}ms": 1e3 * v / n, "share": v / total}
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
    phases.reset()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            _sync(dev)
            t0 = time.perf_counter()
            with torch.profiler.record_function(ROUND_TRIP):
                round_trip(codec, x, quality, ref)
            _sync(dev)
            traced_ms = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(tmp, TRACE_FILE)) as f:
            trace = json.load(f)
    rec.update({f"{pre}untraced_round_trip_ms": statistics.median(walls),
                f"{pre}traced_round_trip_ms": traced_ms})
    if not card:
        rec["device_time"] = "not measured: no card"
        rec["phases"] = {k: {"calls": v} for k, v in phases.calls.items()}
        return rec
    per, busy = attribute_device_time(trace, list(phases.calls))
    rows = {k: {"calls": phases.calls.get(k, 0), "device_ms": ms, "events": ev,
                "share": ms / sum(v[0] for v in per.values())} for k, (ms, ev) in per.items()}
    for k, c in phases.calls.items():  # phases that launched nothing on the card
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
    codec = ProfiledCodec(seeded_model(model_config(args.config), dev), lanes=args.lanes,
                          device=dev, mode=args.mode)
    codec.update()
    w, h = (int(v) for v in args.size.split("x"))
    rec = profile(codec, torch.from_numpy(seeded_image(h, w)).to(dev), args.quality, args.n)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
