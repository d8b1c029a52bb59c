"""Benchmark: Kodak-size images/s per card, encode+decode, at q=10 and q=5.

Counterpart of the root bench.py together with tools/probe_honest.py: the
orchestrator and the probe are one module here, the probe being its
`--probe` mode.  The last line of standard output is one JSON object with
the root bench's keys: `metric` (`kodak_enc_dec_images_per_s_per_chip_q10`),
`value`, `unit`, `vs_baseline`, `q5_images_per_s`,
`per_image_stream_images_per_s`, `pipelined_shallow_queue_images_per_s`,
`transform_gflops_per_image`, `mfu`, `peak_note`, `baseline_note` and
`protocol_note`, plus `device`, `nvidia_smi` (the card's name and power
limit) and `probes` (each configuration's record).

Model and input.  The flagship `ModelConfig()` (or `--config`, a
ModelConfig JSON file), neither width nor depth cut, with `init_params`
weights from `--seed`: throughput does not depend on weight values, and
every process rebuilds the same weights from the seed (each record carries
`weights_sha256`), where the root bench pickles its params for its probes.
`GranularCodec(model, lanes=512)`, one stream (`groups=1`), fixed lanes.
The images are 768x512 (`--size`), drawn from the seed with numpy, one
batch per chain.  `device.set_deterministic()` runs before the model is
built, so sigma, the mask and the indexes have the same bits on encode and
decode.

Protocol.  Each (quality, batch) of (10, 8), (10, 1) and (5, 8) runs in a
fresh process (`subprocess.run`), since a process's state moves its
timings; the probe writes its record as JSON to `--out-dir`.  A chain is
`codec.decompress(codec.compress(x, quality=q))` on the device dict, with
no bytes.  After one warm-up chain and `torch.cuda.synchronize()`:
  * `images_per_s_scalar_fenced`: `--n` chains enqueued back to back, then
    one completion sync (the last line's
    `pipelined_shallow_queue_images_per_s`, from the (10, 8) probe).  The
    codec syncs inside every call (compress reads the stream's length,
    decompress reads `stream_ok`), so the queue never runs ahead of the
    host by more than one call, and this figure shows those syncs;
  * `forced_sync_images_per_s`: 6 chains, each followed by
    `torch.cuda.synchronize()`, the host clock around each; the headline
    `value` is the larger of the (10, 8) and (10, 1) figures.  The record
    also gives the mean, median, p90 (linear interpolation) and max ms per
    image over those chains, and the rANS kernel launches per chain.
Checks, each of which raises and ends the probe with a nonzero exit, which
makes the orchestrator raise: `stream_ok` on every chain; finite x_hat;
the decoded y_hat equal bit for bit to the encoder's
`compress(..., simulate=True)` y_hat; and one compress -> serialize ->
deserialize -> decompress (`profile_codec.round_trip`) decoding to that same
y_hat, whose bytes, bpp and wall time (`container_round_trip_ms`) the record
gives.

FLOPs and MFU.  The (10, 8) probe counts, after its timings, the
convolution and product FLOPs (`utils/flops.flops_by_kind`) of
`forward_single_quality` at q=10, `analyze`, `codec_hyper_enc` and
`codec_synth(1, .)` at batch 1: encode = forward - synth, decode = forward
- analyze - hyper_enc, chain = encode + decode (as bench.py:157-191 splits
them).  `mfu` = chain FLOPs x `value` / `chip_peak_flops()`, the card's
float32 peak with TF32 off, because the codec runs in float32.  The port
counts a transposed convolution's real products, where JAX's counter
counts s^2 times as many, so `transform_gflops_per_image` is below JAX's
count of the same chain.  The root bench's gate stays: an MFU at or above 1
raises, since it means the timing fence does not catch the compute.  The
flagship's forward alone runs at an MFU of about 0.12 on an NVIDIA H100
80GB HBM3 at 700 W (PERF.md section 5); a chain MFU far from that points
at the timing or the count.

Device.  `--device` defaults to `cuda`; without a card it raises
(`device.resolve_device`) and never falls back to the CPU.  With `--device
cpu` (tests: `--config` and `--size` for a small model and image) the same
protocol runs on the host, `device` is "cpu" and `mfu` reads "not
measured: no card", without the gate.

Usage:
    python -m progressivecodec_tpu_torch.bench [--n 4] [--seed 0] [--out-dir .]
        [--size 768x512] [--config cfg.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from progressivecodec_tpu_torch.coder import rans_cuda
from progressivecodec_tpu_torch.device import resolve_device, set_deterministic
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.tools.profile_codec import (
    _sync, model_config, round_trip, seeded_image, seeded_model,
)
from progressivecodec_tpu_torch.utils.flops import chip_peak_flops, flops_by_kind

METRIC = "kodak_enc_dec_images_per_s_per_chip_q10"
# (quality, batch): q=5 exercises the sigma-quantile mask (q=10
# short-circuits it to all ones); batch 1 is the per-image-stream figure
CONFIGS = ((10.0, 8), (10.0, 1), (5.0, 8))
LANES = 512
N_FORCED = 6
# the reference's fastest published decode-only time, 2.30 s per image
BASELINE_IMAGES_PER_S = 1.0 / 2.30
PROBE_TIMEOUT_S = 1200
REPO = Path(__file__).resolve().parents[1]
NO_CARD = "not measured: no card"


def chain(codec: GranularCodec, x: torch.Tensor, quality: float) -> dict:
    """One encode + decode on the device dict, no bytes (the root probe's
    `to_host=False`)."""
    return codec.decompress(codec.compress(x, quality=quality))


def _check_stream(out: dict, label: str) -> None:
    if not out["stream_ok"]:
        raise RuntimeError(f"{label}: stream_ok is False")


def weights_digest(model) -> str:
    """sha256 over the state dict's names, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def chain_flops(model, h: int, w: int, device) -> dict:
    """Convolution and product FLOPs of one h x w image's chain, by kind
    ({"conv", "conv_transpose", "matmul"}), for each counted fragment and
    for "encode", "decode" and "chain"."""
    x = torch.zeros((1, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        y = model.analyze(x)
        # the decoder's synthesis reads the division_channel-wide latent
        y_hat = torch.zeros(y.shape[:3] + (model.cfg.division_channel,), dtype=torch.float32,
                            device=device)
        parts = {
            "forward": flops_by_kind(model.forward_single_quality, x, 10.0),
            "analyze": flops_by_kind(model.analyze, x),
            "hyper_enc": flops_by_kind(model.codec_hyper_enc, y),
            "synth": flops_by_kind(model.codec_synth, 1, y_hat),
        }
    fwd, ana, hyp, syn = (parts[k] for k in ("forward", "analyze", "hyper_enc", "synth"))
    parts["encode"] = {k: fwd[k] - syn[k] for k in fwd}
    parts["decode"] = {k: fwd[k] - ana[k] - hyp[k] for k in fwd}
    parts["chain"] = {k: parts["encode"][k] + parts["decode"][k] for k in fwd}
    return parts


def gated_mfu(chain_flops_per_image: int, images_per_s: float, peak: float) -> float:
    """chain FLOPs x images/s over the peak, under the root bench's gate
    (bench.py:197-204).  A bench that can print an MFU >= 1 is broken by
    construction: if this trips, the timing fence is not a completion
    fence; fix the protocol, never the gate."""
    mfu = chain_flops_per_image * images_per_s / peak
    if not mfu < 1.0:
        raise AssertionError(
            f"IMPOSSIBLE MEASUREMENT: mfu={mfu:.3f} >= 1.0 "
            f"({chain_flops_per_image / 1e9:.1f} GF/img x {images_per_s:.1f} img/s vs "
            f"{peak / 1e12:.0f} TF/s peak) — timing fence is not catching compute"
        )
    return mfu


def _size(s: str) -> tuple[int, int]:
    """'WIDTHxHEIGHT' -> (h, w)."""
    w, h = (int(v) for v in s.split("x"))
    return h, w


def probe(args) -> dict:
    """One (quality, batch) measured in this process; the record, also
    printed and written to `record_path` in `args.out_dir`."""
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    set_deterministic()
    model = seeded_model(model_config(args.config), dev, args.seed)
    codec = GranularCodec(model, lanes=LANES, groups=1, lane_policy="fixed", device=dev)
    codec.update()
    (h, w), q, b = _size(args.size), args.quality, args.batch
    label = f"q={q:g} b={b}"
    xs = [torch.from_numpy(seeded_image(h, w, args.seed + 1 + i, b)).to(dev) for i in range(args.n)]

    _check_stream(chain(codec, xs[0], q), f"{label} warm-up")
    _sync(dev)

    t0 = time.perf_counter()
    for x in xs:
        _check_stream(chain(codec, x, q), label)
    _sync(dev)
    pipelined_s = time.perf_counter() - t0

    scans = {"encode": rans_cuda.rans_encode_scan, "decode": rans_cuda.rans_decode_scan,
             "grouped_decode": rans_cuda.rans_decode_scan_grouped}
    before = {k: f.launches for k, f in scans.items()}
    per_chain_s = []
    for _ in range(N_FORCED):
        t0 = time.perf_counter()
        out = chain(codec, xs[0], q)
        _sync(dev)
        per_chain_s.append(time.perf_counter() - t0)
        _check_stream(out, label)
    launches = {k: (f.launches - before[k]) / N_FORCED for k, f in scans.items()}

    if not bool(torch.isfinite(out["x_hat"]).all()):
        raise RuntimeError(f"{label}: x_hat is not finite")
    ref = codec.compress(xs[0], quality=q, simulate=True)["y_hat"]
    if not torch.equal(out["y_hat"], ref):
        raise RuntimeError(f"{label}: decoded y_hat != the encoder's simulated y_hat")
    _sync(dev)
    t0 = time.perf_counter()
    n_bytes = round_trip(codec, xs[0], q, ref)
    _sync(dev)
    container_ms = 1e3 * (time.perf_counter() - t0)

    ms = 1e3 * np.asarray(per_chain_s) / b
    rec = {
        "pid": os.getpid(), "quality": q, "batch": b, "size": [h, w], "model": codec.cfg.name,
        "lanes": LANES, "groups": 1, "seed": args.seed, "weights_sha256": weights_digest(model),
        "device": torch.cuda.get_device_name(dev) if card else "cpu",
        "n_chains": args.n, "n_forced": N_FORCED,
        "images_per_s_scalar_fenced": args.n * b / pipelined_s,
        "forced_sync_images_per_s": N_FORCED * b / sum(per_chain_s),
        "ms_per_image_mean": float(ms.mean()), "ms_per_image_median": float(np.median(ms)),
        "ms_per_image_p90": float(np.percentile(ms, 90)), "ms_per_image_max": float(ms.max()),
        "launches_per_chain": launches,
        "stream_ok_all": True, "x_hat_finite": True, "y_hat_exact": True,
        "bytes": n_bytes, "bpp": 8 * n_bytes / (b * h * w), "container_round_trip_ms": container_ms,
    }
    if card:
        rec["nvidia_smi"] = card_line()
    if (q, b) == CONFIGS[0]:  # counted once, in the headline's probe
        rec["flops"] = chain_flops(model, h, w, dev)
        if card:
            rec["peak_flops"], rec["peak_note"] = chip_peak_flops(dev)
    print(json.dumps(rec), flush=True)
    with open(record_path(args.out_dir, q, b), "w") as f:
        json.dump(rec, f)
    return rec


def record_path(out_dir: str, quality: float, batch: int) -> str:
    return os.path.join(out_dir, f"bench_probe_q{quality:g}_b{batch}.json")


def run_probe(args, quality: float, batch: int) -> dict:
    """One (quality, batch) in a fresh process; its record.  Raises, with
    the end of the probe's output, if it exits nonzero."""
    cmd = [sys.executable, "-m", "progressivecodec_tpu_torch.bench", "--probe",
           "--quality", str(quality), "--batch", str(batch), "--n", str(args.n),
           "--seed", str(args.seed), "--size", args.size, "--device", args.device,
           "--out-dir", args.out_dir]
    if args.config is not None:
        cmd += ["--config", os.path.abspath(args.config)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=PROBE_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(
            f"probe q={quality:g} b={batch} failed rc={proc.returncode}:\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
        )
    with open(record_path(args.out_dir, quality, batch)) as f:
        r = json.load(f)
    if not (r["stream_ok_all"] and r["x_hat_finite"] and r["y_hat_exact"]):
        raise RuntimeError(f"probe q={quality:g} b={batch}: a check failed: {r}")
    return r


def bench(args) -> dict:
    """The three probes, one process each, and the last line's record."""
    dev = resolve_device(args.device)  # raises here, before any probe, without a card
    card = dev.type == "cuda"
    probes = {}
    for q, b in CONFIGS:
        r = probes[(q, b)] = run_probe(args, q, b)
        print(f"probe q={q:g} b={b} (pid {r['pid']}): forced {r['forced_sync_images_per_s']:.3f} "
              f"images/s, median {r['ms_per_image_median']:.2f} ms/image, {r['bytes']} bytes",
              flush=True)
    b8, b1, q5 = (probes[k] for k in CONFIGS)
    value = max(b8["forced_sync_images_per_s"], b1["forced_sync_images_per_s"])
    chain_fl = sum(b8["flops"]["chain"].values())
    counted = ("transposed convolutions counted by their real products; JAX's counter counts "
               "s^2 times as many (the zeros of its lhs-dilated form), so the GFLOP are below "
               "JAX's count of the same chain")
    if card:
        mfu = gated_mfu(chain_fl, value, b8["peak_flops"])
        peak_note = (f"{b8['peak_note']}: the codec runs in float32 with TF32 off "
                     f"(device.set_deterministic), so the float32 peak, not bf16; {counted}")
    else:
        mfu, peak_note = NO_CARD, f"{NO_CARD}; {counted}"
    result = {
        "metric": METRIC,
        "value": value,
        "unit": "images/s",
        "vs_baseline": value / BASELINE_IMAGES_PER_S,
        "q5_images_per_s": q5["forced_sync_images_per_s"],
        "per_image_stream_images_per_s": b1["forced_sync_images_per_s"],
        "pipelined_shallow_queue_images_per_s": b8["images_per_s_scalar_fenced"],
        "transform_gflops_per_image": chain_fl / 1e9,
        "mfu": mfu,
        "peak_note": peak_note,
        "baseline_note": "ref fastest decode-ONLY anchor 2.30 s/img; ours is encode+decode",
        "protocol_note": (
            "value = max over q=10 batch 8 and batch 1 of the forced-sync throughput: 6 chains "
            "(compress then decompress on the device dict, no bytes), each followed by "
            "torch.cuda.synchronize(), host clock around each, after one warm-up chain; one "
            "(quality, batch) per fresh process; pipelined_shallow_queue = "
            f"{args.n} chains enqueued back to back then one synchronize, bounded by the "
            "codec's own syncs in compress (stream length) and decompress (stream_ok); every "
            "chain stream_ok, the decoded y_hat bit-exact to the encoder's simulated y_hat, one "
            "container round trip per probe; probe records in "
            f"{os.path.join(args.out_dir, 'bench_probe_q*_b*.json')}"
        ),
        "device": b8["device"],
        "nvidia_smi": card_line() if card else NO_CARD,
        "probes": {f"q{q:g}_b{b}": r for (q, b), r in probes.items()},
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4, help="chains of the pipelined pass")
    p.add_argument("--seed", type=int, default=0, help="weights; image i of a probe uses seed + 1 + i")
    p.add_argument("--size", type=str, default="768x512", help="WIDTHxHEIGHT")
    p.add_argument("--config", type=str, default=None, help="ModelConfig JSON file")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out-dir", type=str, default=".", help="where the probes write their records")
    p.add_argument("--probe", action="store_true", help="measure one configuration in this process")
    p.add_argument("--quality", type=float, default=10.0, help="(--probe)")
    p.add_argument("--batch", type=int, default=8, help="(--probe)")
    args = p.parse_args(argv)
    args.out_dir = os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    return probe(args) if args.probe else bench(args)


if __name__ == "__main__":
    main()
