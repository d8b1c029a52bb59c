"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison with the plain reference, and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`, its
configuration file, the plain reference that file names under
`benchmark/reference/`, its traffic mix under `benchmark/traffic/`, and each
per-layer metric's reader under `benchmark/metrics/`.  From the program
(`progressivecodec_tpu_torch`) the run takes only the system under test:
the model and `GranularCodec`, the fragments and coder phases it wraps in
spans, and its kernels' names.

The request is the port's main path, closed loop with one client:
`compress` -> `serialize` -> `deserialize` -> `decompress`, then a device
sync; it fails when `stream_ok` is false or `x_hat` is not finite.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, trace, traffic, weights
from benchmark.reference import coder

FORBIDDEN = ("jax", "jaxlib", "flax", "progressivecodec_tpu")


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r}")


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration file, its traffic mix)."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = find(bench["workloads"], workload, "workload")
    with open(root / find(bench["configs"], cell["config"], "config")["file"]) as f:
        conf = json.load(f)
    return bench, cell, conf, traffic.load_mix(root, cell["traffic"])


def metric_reader(root: Path, name: str):
    """`benchmark/metrics/<name>.py`, else the reader of the name's first
    part (`encode_ms` for `encode_ms.lat`): its `read(run)`."""
    base = root / "benchmark" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")


def reference(root: Path, conf: dict):
    """The plain reference module a configuration names (`"reference"`,
    `model` where absent): `benchmark/reference/<stem>.py` under `root`,
    registered in `sys.modules` as `benchmark_reference_<stem>` so that the
    yardstick finds it from the `Cfg` it makes."""
    stem = conf.get("reference", "model")
    name = f"benchmark_reference_{stem}"
    spec = importlib.util.spec_from_file_location(name, root / "benchmark" / "reference" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return time.time() - (btime + start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, StopIteration, IndexError):
        return None


class Clocks:
    """`nvidia-smi` sampling the card's SM clock, power and temperature once
    a second beside the window, into `build/bench_clocks/` in the checkout."""

    QUERY = "timestamp,clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, root: Path, name: str, dev: torch.device):
        self.proc, self.path = None, None
        if dev.type != "cuda" or shutil.which("nvidia-smi") is None:
            return
        self.path = root / "build" / "bench_clocks" / f"{name}.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w")
        self.proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                                      "-i", str(dev.index or 0), "-lms", "1000"],
                                     stdout=self._f, stderr=subprocess.DEVNULL)

    def stop(self) -> str:
        if self.proc is None:
            return "clocks not sampled"
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._f.close()
        rows = [r.split(", ") for r in self.path.read_text().splitlines() if r.count(",") == 4]
        try:
            sm = [float(r[1]) for r in rows]
            pw = [float(r[2]) for r in rows]
            temp = [float(r[4]) for r in rows]
            return (f"clocks over {len(rows)} samples: SM {min(sm):.0f}-{statistics.median(sm):.0f}-"
                    f"{max(sm):.0f} MHz, power up to {max(pw):.1f} W of {rows[0][3]} W, "
                    f"temperature up to {max(temp):.0f} C ({self.path.name})")
        except (ValueError, IndexError):
            return f"clocks: {len(rows)} samples unread ({self.path.name})"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The system under test, built from a configuration file, with the
    weights drawn by the spec of its reference module `ref`."""

    def __init__(self, conf: dict, dev: torch.device, log, ref):
        from progressivecodec_tpu_torch import device as pdev
        from progressivecodec_tpu_torch.coder import rans_device
        from progressivecodec_tpu_torch.config import model_config_from_json
        from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
        from progressivecodec_tpu_torch.models.registry import get_model

        log(f"process age {process_age_s()} s once the program is imported")
        pdev.set_deterministic()
        t = time.perf_counter()
        self.model = get_model(model_config_from_json(json.dumps(conf["model"])), device=dev)
        sd = weights.config_weights(ref, conf, dev)
        self.model.load_state_dict(sd, strict=True)
        del sd
        _sync(dev)
        log(f"model built and loaded in {time.perf_counter() - t:.3f} s")
        self.codec = GranularCodec(self.model, device=dev, **conf["codec"])
        t = time.perf_counter()
        self.codec.update()
        _sync(dev)
        self.update_s = time.perf_counter() - t
        log(f"codec.update() (CDF tables) {self.update_s:.3f} s")
        self.coder_module = rans_device
        self.dev = dev

    def request(self, x, quality: float) -> dict:
        """One round trip; host seconds of encode (compress + serialize) and
        decode (deserialize + decompress), each ending in a sync."""
        t0 = time.perf_counter()
        blob = self.codec.serialize(self.codec.compress(x, quality=quality))
        _sync(self.dev)
        t1 = time.perf_counter()
        out = self.codec.decompress(self.codec.deserialize(blob))
        ok = bool(out["stream_ok"]) and bool(torch.isfinite(out["x_hat"]).all())
        _sync(self.dev)
        t2 = time.perf_counter()
        return {"blob": blob, "x_hat": out["x_hat"], "y_hat": out["y_hat"], "ok": ok,
                "enc_s": t1 - t0, "dec_s": t2 - t1}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace_on: bool,
             dev: torch.device, started: float, log=print, program_factory=Program) -> dict:
    """One run; returns the result line's object (with "checks" last)."""
    bench, cell, conf, mix = load_cell(root, workload)
    ref = reference(root, conf)
    cfg = ref.Cfg(conf["model"])
    prog = program_factory(conf, dev, log, ref)
    t = time.perf_counter()
    pool = traffic.image_pool(mix, dev)
    sched = traffic.Schedule(mix, seed)
    _sync(dev)
    log(f"image pool {tuple(pool.shape)} in {time.perf_counter() - t:.3f} s")
    batch, h, w = int(mix["batch"]), int(mix["height"]), int(mix["width"])

    def images(idx):
        return pool[torch.as_tensor(idx, device=dev)]

    t = time.perf_counter()
    for j, q in enumerate(mix["warmup_qualities"]):
        r = prog.request(images([(j * batch + k) % len(pool) for k in range(batch)]),
                         float(np.float32(q)))
        if not r["ok"]:
            raise RuntimeError(f"warm-up request at q={q} failed its checks")
    _sync(dev)
    log(f"warm-up ({len(mix['warmup_qualities'])} requests) {time.perf_counter() - t:.3f} s")

    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - started
    reqs, kept, first_error = [], {}, None
    clocks = Clocks(root, f"{workload}-{seed}-{'trace' if trace_on else 'plain'}", dev)
    win0 = time.perf_counter()
    i = 0
    while time.perf_counter() - win0 < seconds:
        idx, q = sched(i)
        t0 = time.perf_counter()
        try:
            r = prog.request(images(idx), q)
        except Exception:  # a request that raises is a failed request
            first_error = first_error or traceback.format_exc()
            r = {"ok": False, "blob": b"", "enc_s": 0.0, "dec_s": 0.0}
        t1 = time.perf_counter()
        reqs.append({"i": i, "q": q, "ok": r["ok"], "lat": t1 - t0, "done": t1 - win0,
                     "bytes": len(r["blob"]), "enc_s": r["enc_s"], "dec_s": r["dec_s"]})
        if i in sched.checked and r["ok"]:
            kept[i] = (idx, q, r["blob"], r["x_hat"], r["y_hat"])
        i += 1
    log(clocks.stop())
    if first_error:
        log(first_error)
    in_window = [r for r in reqs if r["done"] <= seconds]
    good = [r for r in in_window if r["ok"]]
    pixels = batch * h * w
    run = {"cfg": cfg, "batch": batch, "height": h, "width": w, "requests": in_window}
    metrics: dict = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"])}
    breakdown = None
    if not trace_on:
        e2e = {m["name"]: m for m in bench["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]}
        vals = {"images_per_s": batch * len(good) / seconds,
                "bits_per_pixel": 8 * sum(r["bytes"] for r in good) / max(pixels * len(good), 1),
                "setup_s": setup_s}
        if in_window:
            vals["p95_ms"] = 1e3 * float(np.percentile([r["lat"] for r in in_window], 95))
        for name, m in e2e.items():
            if name in vals:
                metrics[name] = {"value": vals[name], "unit": m["unit"]}
    else:
        traced = traced_window(prog, sched, images, i, conf, mix, dev, log)
        run.update(traced)
        device_info.update({"busy_s": traced["busy_s"], "window_s": traced["window_s"]})
        breakdown = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                        if dev.type == "cuda" else 0)

    # the program's state goes before the reference runs
    update_s = prog.update_s
    del prog, pool, images
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limits, worst, tables = check(kept, conf, mix, ref, cfg, dev, log)
    run["cdf_length"] = tables.cdf_length
    log(f"comparison with the reference ({len(kept)} requests) {time.perf_counter() - t:.3f} s")
    if trace_on:
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = metric_reader(root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the traced sub-window's requests count as the window's do
    done = reqs + run.get("profiled", [])
    failed = sum(not r["ok"] for r in done)
    correct = bool(kept) and failed == 0 and compare.verdict(worst, limits)
    out = {"correct": correct, "attempted": len(done), "failed": failed, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup"] = {"update_s": update_s}
    out["checks"] = {"requests": sorted(kept), **{k: [worst[k], limits[k]] for k in limits}}
    return out


def traced_window(prog, sched, images, start_i, conf, mix, dev, log) -> dict:
    """`profiled_requests` requests under the profiler, with the program's
    fragments and coder phases in spans."""
    n = int(mix["profiled_requests"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    done = []
    with trace.spans(prog.model, prog.coder_module, conf["fragments"]["transforms"]
                     + conf["fragments"]["slice_nets"], conf["coder_phases"] + conf["scan_phases"]):
        with torch.profiler.profile(activities=acts) as prof:
            _sync(dev)
            t0 = time.perf_counter()
            for k in range(n):
                idx, q = sched(start_i + k)
                with torch.profiler.record_function(trace.REQUEST):
                    r = prog.request(images(idx), q)
                done.append({"q": q, "bytes": len(r["blob"]), "ok": r["ok"],
                             "payload_words": payload_words(r["blob"])})
            _sync(dev)
            window_s = time.perf_counter() - t0
    names = ({trace.REQUEST} | {f"frag:{f}" for g in conf["fragments"].values() for f in g}
             | {f"coder:{c}" for c in conf["coder_phases"] + conf["scan_phases"]})
    ch = trace.charge(prof.profiler.kineto_results.events(), names)
    t_lo = min((r[0] for r in ch["ranges"] if r[2] == trace.REQUEST), default=0)
    t_hi = max((r[1] for r in ch["ranges"] if r[2] == trace.REQUEST), default=0)
    log(f"traced {n} requests: {window_s:.3f} s, {len(ch['ranges'])} host ranges, "
        f"{ch['launches']} launches, {ch['device_events']} device events, {ch['unlinked']} "
        f"not linked to a launch, busy {ch['busy_s']:.4f} s")
    top = sorted(ch["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"profiled": done, "charged": ch, "window_s": window_s, "busy_s": ch["busy_s"],
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": trace.idle_gaps(ch, t_lo, t_hi),
            "fragments": conf["fragments"], "coder_phases": conf["coder_phases"],
            "scan_kernels": conf["scan_kernels"], "device_kind": (torch.cuda.get_device_name(dev)
                                                                  if dev.type == "cuda" else "cpu"),
            "lanes": int(conf["codec"]["lanes"])}


def payload_words(blob: bytes) -> int:
    c = coder.parse_container(blob)
    return len(c["words"])


def check(kept: dict, conf: dict, mix: dict, ref, cfg, dev, log):
    """The reference module `ref` on each kept request: (limits, the worst
    of each number, the reference's coder tables)."""
    limits = compare.LIMITS
    worst = {k: 0.0 for k in limits} if kept else {k: math.inf for k in limits}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    P = weights.config_weights(ref, conf, dev)
    pool = traffic.image_pool(mix, dev)
    eb = {k.split(".")[-1]: v.cpu().numpy() for k, v in P.items() if "entropy_bottleneck" in k}
    tables = coder.Tables(eb, cfg.scale_table)
    lanes, batch = int(conf["codec"]["lanes"]), int(mix["batch"])
    mask_pol = conf["model"].get("mask_policy", "point-based-std")
    for i, (idx, q, blob, x_hat, y_hat) in sorted(kept.items()):
        r = ref.reference_request(P, cfg, pool[torch.as_tensor(idx, device=dev)], q)
        nums = compare.compare(r, blob, x_hat, y_hat, tables, lanes, batch, q, mask_pol)
        log(f"check request {i} q={q}: " + ", ".join(f"{k} {nums[k]:.6g}" for k in limits)
            + f" (bytes {len(blob)}, reference {nums['ref_bytes']}; x_hat inside (0, 1): "
            f"{float(((r['x_hat'] > 0) & (r['x_hat'] < 1)).float().mean()):.4f})")
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    return limits, worst, tables
