"""Coder micro-benchmark: encode and decode throughput against the lane count.

Counterpart of tools/bench_coder.py, on the same inputs: the merged Gaussian
tables of `ScaleTableConfig()`, `--n` symbols over `--stages` stages, each
symbol's CDF row uniform over every row, symbols round(N(0, 1) * 4), every
symbol kept.  For each lane count K of `--lanes` it encodes with
`rans_device.encode_stages` and decodes with `decoder_init`, then
`decode_stage_scan` and `decode_stage_values` per stage; the decoded values
must equal the symbols and `stream_ok` must hold.  It prints one JSON line
per K: the encode and decode ms and Msym/s (the mean of `--reps` runs after
a warm-up), the stream's words, the decode launch plan of the stages'
rows (CTAs per stream, threads per CTA, cluster or grid, stream ring,
bucket shift or the global table) and the card's name and power limit.

On the card (the default) the times are CUDA events around each run.  With
`--device cpu` the scans run as their plain PyTorch twins: the lines say
`"device": "cpu"` and carry host-clock times under `host_*` names, and the
plan is the one the card would take at the H100's shared-memory budget.

Usage:
    python -m progressivecodec_tpu_torch.tools.bench_coder [--lanes 512,1024,2048,4096]
        [--n 2000000] [--stages 21] [--reps 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.tables import merge_tables
from progressivecodec_tpu_torch.config import ScaleTableConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables

H100_SMEM_OPTIN = 232_448  # bytes of shared memory one H100 block can opt into


def make_stages(n_rows: int, n: int, n_stages: int, seed: int = 0):
    """tools/bench_coder.py's stages: (symbols, indexes, keep) numpy arrays."""
    rng = np.random.default_rng(seed)
    per = n // n_stages
    stages = []
    for _ in range(n_stages):
        idx = rng.integers(0, n_rows, per).astype(np.int32)
        sym = np.round(rng.standard_normal(per) * 4).astype(np.int32)
        stages.append((sym, idx, np.ones(per, bool)))
    return stages


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def encode(stages, t, lanes):
    """One stream: its words as a (1, W) row, and its escape words."""
    streams, n_words, escs, n_escs = rans_device.encode_stages(stages, t, lanes)
    return streams[:, : int(n_words[0])], escs[0, : 2 * int(n_escs[0])]


def decode(streams, esc, stages, t, lanes):
    """Every stage's values and the final decoder state."""
    escs = torch.nn.functional.pad(esc, (0, 2))[None]
    dec = rans_device.decoder_init(streams, lanes)
    outs = []
    for _, idx, keep in stages:
        ig = rans_device._pad_to_grid(idx, lanes)
        kg = rans_device._pad_to_grid(keep.to(torch.uint8), lanes)
        states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
        esc_offsets, vals = rans_device.decode_stage_values(dec.esc_offsets, cums, escs, idx, keep, t, lanes)
        dec = rans_device.DecoderState(states, offsets, esc_offsets)
        outs.append(vals)
    return outs, dec


def timed(fn, dev, reps: int):
    """(result of the last run, mean ms per run): CUDA events on the card,
    the host clock on the CPU; one warm-up run first."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, 1e3 * (time.perf_counter() - t0) / reps


def bench(lanes: int, stages, t, compact, dev, reps: int, card: str | None) -> dict:
    """One lane count: encode, decode, check, and the JSON record."""
    (stream, esc), enc_ms = timed(lambda: encode(stages, t, lanes), dev, reps)
    (outs, dec), dec_ms = timed(lambda: decode(stream, esc, stages, t, lanes), dev, reps)
    for (sym, _, keep), vals in zip(stages, outs):
        if not torch.equal(vals, torch.where(keep, sym, 0)):
            raise AssertionError(f"K={lanes}: decoded values != symbols")
    if not bool(rans_device.stream_ok(dec)) or int(dec.offsets) != stream.numel():
        raise AssertionError(f"K={lanes}: stream_ok is False")
    cap = rans_cuda._smem_optin(dev.index or 0) if dev.type == "cuda" else H100_SMEM_OPTIN
    plan = rans_cuda.plan_decode(compact, (0, compact.meta.shape[0]), lanes, cap)
    n = sum(int(s[0].numel()) for s in stages)
    rec = {"lanes": lanes, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "n": n,
           "words": int(stream.numel()), "escape_words": int(esc.numel()), "values_exact": True,
           "stream_ok": True,
           "plan": {"ctas": plan.ctas, "cta_lanes": plan.cta_lanes,
                    "route": "grid" if plan.grid else "cluster" if plan.ctas > 1 else "one CTA",
                    "ring_words": plan.ring_words, "table_in_smem": plan.table_in_smem,
                    "shift": plan.shift, "smem_bytes": plan.smem_bytes}}
    if dev.type == "cuda":
        rec.update(nvidia_smi=card, enc_Msym_per_s=n / enc_ms / 1e3, dec_Msym_per_s=n / dec_ms / 1e3,
                   enc_ms=enc_ms, dec_ms=dec_ms)
    else:
        rec.update(host_enc_ms=enc_ms, host_dec_ms=dec_ms)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=str, default="512,1024,2048,4096")
    p.add_argument("--n", type=int, default=2_000_000, help="symbols in all (~Kodak 768x512, all slices)")
    p.add_argument("--stages", type=int, default=21, help="decode stages (z + 20 slices)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    merged, _ = merge_tables(build_gaussian_tables(ScaleTableConfig().values()))
    t = rans_device.DeviceTables.from_tables(merged, dev)
    compact = t.compact or rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    stages = [tuple(torch.from_numpy(a).to(dev) for a in s)
              for s in make_stages(merged.cdf.shape[0], args.n, args.stages)]
    card = card_line() if dev.type == "cuda" else None
    for lanes in [int(x) for x in args.lanes.split(",")]:
        print(json.dumps(bench(lanes, stages, t, compact, dev, args.reps, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
