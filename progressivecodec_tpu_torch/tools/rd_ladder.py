"""Resumable real-codec RD ladder from a checkpoint, with BD-rate.

Counterpart of tools/rd_ladder.py.  It reads a checkpoint of the port's
trainer (`cli/train.py`: a directory with state.pt and config.json; the
JAX package's Orbax checkpoints are not read), builds
`GranularCodec(lanes=..., lane_policy=auto|fixed)` on its weights and codes
`--n-images` SyntheticKodak images at every quality of the grid (`full`,
`utils/rd.QUALITY_GRID`'s 61 qualities, or `coarse`, 12), one warm codec
for every point.  Each point is appended to `--out-jsonl` the moment it
completes, with JAX's keys (quality, bpp, psnr, ms_ssim_db, enc_time,
dec_time in seconds, n_images, wall_s); a run that finds the file resumes,
skipping the qualities already on disk.  The final `--out` JSON is rebuilt
from the JSONL, a partial one too: the points by quality, the largest
adjacent MS-SSIM jump and the count of drops over 0.15 dB (a metric that
jumps on the same images points at a precision fault), and
`bd_rate_vs_fixed_pret`, the BD-rate of the q > 0 points against the
reference's progressive anchor (`utils/rd.PROGRESSIVE_ANCHOR_*`).  On the
card each record carries the card's name and power limit.  Unlike
`cli/rd_sweep.py` it resumes, reads only checkpoints and times each point.

Usage:
    python -m progressivecodec_tpu_torch.tools.rd_ladder --checkpoint runs/exp1/ckpt_last
        [--grid full|coarse] [--n-images 24] [--out-jsonl rd_ladder_points.jsonl]
        [--out rd_ladder.json] [--lanes 512] [--lane-policy auto|fixed] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.cli.rd_sweep import COARSE_GRID, bd_rate_vs_fixed_pret
from progressivecodec_tpu_torch.data.datasets import SyntheticKodak
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.training.checkpoint import read_checkpoint
from progressivecodec_tpu_torch.training.evaluate import evaluate_codec
from progressivecodec_tpu_torch.utils.rd import QUALITY_GRID

GRIDS = {"full": QUALITY_GRID, "coarse": COARSE_GRID}


def load_checkpoint_model(path: str, device):
    """(model on `device` with the checkpoint's weights, its ModelConfig,
    its step) of a port checkpoint directory."""
    payload, meta = read_checkpoint(path)
    cfg = config_lib.model_config_from_json(json.dumps(meta["model"]))
    model = get_model(cfg, device=device)
    model.load_state_dict(payload["model"], strict=True)
    return model, cfg, int(payload["step"])


def read_points(path: str) -> list[dict]:
    """The records of a ladder JSONL; a line cut by a kill is skipped."""
    if not os.path.exists(path):
        return []
    points = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
                float(rec["quality"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue
            points.append(rec)
    return points


def ladder_result(points: list[dict]) -> dict:
    """The final artifact's RD fields from the points, sorted by quality."""
    points = sorted(points, key=lambda r: r["quality"])
    result = {"qualities": [r["quality"] for r in points], "bpp": [r["bpp"] for r in points],
              "psnr": [r["psnr"] for r in points], "ms_ssim_db": [r["ms_ssim_db"] for r in points]}
    ms = result["ms_ssim_db"]
    if len(ms) >= 2:
        result["ms_ssim_db_max_adjacent_jump"] = round(max(abs(b - a) for a, b in zip(ms, ms[1:])), 3)
        result["ms_ssim_db_monotone_violations"] = sum(1 for a, b in zip(ms, ms[1:]) if b < a - 0.15)
    prog = [(r["bpp"], r["psnr"]) for r in points if r["quality"] > 0]
    result["bd_rate_vs_fixed_pret"] = bd_rate_vs_fixed_pret([b for b, _ in prog],
                                                            [p for _, p in prog])
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--grid", choices=sorted(GRIDS), default="full")
    p.add_argument("--n-images", type=int, default=24)
    p.add_argument("--out-jsonl", type=str, default="rd_ladder_points.jsonl")
    p.add_argument("--out", type=str, default="rd_ladder.json")
    p.add_argument("--lanes", type=int, default=512)
    p.add_argument("--lane-policy", choices=["fixed", "auto"], default="auto",
                   help="auto: per-stream lane counts from container metadata, so low-rate "
                   "points stop paying the full 2*K*2-byte lane-state header")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model, _, step = load_checkpoint_model(args.checkpoint, dev)
    codec = GranularCodec(model, lanes=args.lanes, lane_policy=args.lane_policy, device=dev)
    codec.update()
    ds = SyntheticKodak()
    images = [ds[i] for i in range(min(args.n_images, len(ds)))]
    card = {"nvidia_smi": card_line()} if dev.type == "cuda" else {}

    os.makedirs(os.path.dirname(os.path.abspath(args.out_jsonl)), exist_ok=True)
    done = {float(r["quality"]) for r in read_points(args.out_jsonl)}
    if done:
        print(f"resuming: {len(done)} points already on disk", flush=True)
    coded = []
    for q in GRIDS[args.grid]:
        if q in done:
            continue
        t0 = time.perf_counter()
        res = evaluate_codec(codec, images, pr_list=[q])
        rec = {"quality": q, "bpp": res["bpp"][0], "psnr": res["psnr"][0],
               "ms_ssim_db": res["ms_ssim_db"][0], "enc_time": res["enc_time"][0],
               "dec_time": res["dec_time"][0], "n_images": res["n_images"],
               "wall_s": round(time.perf_counter() - t0, 2), **card}
        with open(args.out_jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        coded.append(q)

    points = read_points(args.out_jsonl)
    result = {"checkpoint": args.checkpoint, "step": step,
              "dataset": f"SyntheticKodak[{len(images)}]", **ladder_result(points),
              "coded_this_run": coded, **card}
    with open(args.out, "w") as f:
        f.write(json.dumps(result, indent=2))
    print(f"wrote {args.out} with {len(points)} points; "
          f"bd_rate={result['bd_rate_vs_fixed_pret']}", flush=True)
    return result


if __name__ == "__main__":
    main()
