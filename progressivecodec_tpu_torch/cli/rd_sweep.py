"""Fine-grained RD sweep: the real codec at every quality of a grid, with
BD-rate against the reference's progressive anchor, as JSON and a plot.

Counterpart of `progressivecodec_tpu/cli/rd_sweep.py`.  --grid full is
`utils/rd.QUALITY_GRID` (61 qualities: 0.0 to 5.0 by 0.1, then 5.5 to 10.0
by 0.5); coarse is 12.  With --checkpoint it sweeps the weights of a
checkpoint of the port's trainer (`cli/train.py`) on the configuration in
its config.json; without, the flagship `ModelConfig()` with seeded random
weights (`init_params`, seed 0).  --device picks the card (default cuda)
or the CPU.  The plot needs matplotlib and is skipped without it.

Usage:
  python -m progressivecodec_tpu_torch.cli.rd_sweep --synthetic-kodak --image 0 \\
      [--grid coarse|full] [--out rd.json] [--plot rd.png] [--device cuda]
  python -m progressivecodec_tpu_torch.cli.rd_sweep --checkpoint runs/exp1/ckpt_best \\
      --dataset /path/to/kodak
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.data.datasets import KodakDataset, SyntheticDataset, SyntheticKodak
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.training.checkpoint import read_checkpoint
from progressivecodec_tpu_torch.training.evaluate import evaluate_codec
from progressivecodec_tpu_torch.utils.rd import (
    PROGRESSIVE_ANCHOR_BPP,
    PROGRESSIVE_ANCHOR_PSNR,
    QUALITY_GRID,
    TRI_PLANET_22_BPP,
    TRI_PLANET_22_PSNR,
    TRI_PLANET_23_BPP,
    TRI_PLANET_23_PSNR,
    bd_rate,
    plot_rd,
    rd_curve_dict,
)

COARSE_GRID = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0)


def bd_rate_vs_fixed_pret(bpp, psnr):
    """BD-rate of (bpp, psnr) against the reference progressive anchor over
    the overlapping range, or "n/a (why)": an untrained model's range may
    not overlap it."""
    try:
        return bd_rate(PROGRESSIVE_ANCHOR_BPP, PROGRESSIVE_ANCHOR_PSNR, bpp, psnr)
    except (ValueError, np.linalg.LinAlgError) as e:
        return f"n/a ({e})"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--image", type=int, default=None, help="single image index")
    p.add_argument("--grid", choices=["coarse", "full"], default="coarse")
    p.add_argument("--out", type=str, default="rd_sweep.json")
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-kodak", action="store_true",
                   help="the fixed 24-image synthetic Kodak-geometry set (data.datasets.SyntheticKodak)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.checkpoint:
        payload, meta = read_checkpoint(args.checkpoint)
        mcfg = config_lib.model_config_from_json(json.dumps(meta["model"]))
        weights = payload["model"]
    else:
        mcfg = ModelConfig()
        weights = init_params(mcfg, torch.Generator().manual_seed(0))
    model = get_model(mcfg, device=args.device)
    model.load_state_dict(weights, strict=True)

    if args.synthetic_kodak:
        ds = SyntheticKodak()
    elif args.synthetic:
        ds = SyntheticDataset(n=1, size=512)
    else:
        ds = KodakDataset(args.dataset)
    images = [ds[args.image]] if args.image is not None else [ds[i] for i in range(len(ds))]
    if args.max_images:
        images = images[: args.max_images]

    grid = list(QUALITY_GRID) if args.grid == "full" else list(COARSE_GRID)
    codec = make_codec(model, device=args.device)
    codec.update()
    res = evaluate_codec(codec, images, pr_list=grid)

    result = {"qualities": grid, "bpp": res["bpp"], "psnr": res["psnr"],
              "ms_ssim_db": res["ms_ssim_db"]}
    result["bd_rate_vs_fixed_pret"] = bd_rate_vs_fixed_pret(res["bpp"][1:], res["psnr"][1:])

    text = json.dumps(result, indent=2)
    print(text)
    with open(args.out, "w") as f:
        f.write(text)
    if args.plot:
        plot_rd(
            [
                rd_curve_dict(PROGRESSIVE_ANCHOR_BPP, PROGRESSIVE_ANCHOR_PSNR, "reference fixed_pret"),
                rd_curve_dict(TRI_PLANET_23_BPP, TRI_PLANET_23_PSNR, "tri_planet_23"),
                rd_curve_dict(TRI_PLANET_22_BPP, TRI_PLANET_22_PSNR, "tri_planet_22"),
                rd_curve_dict(res["bpp"], res["psnr"], "ours"),
            ],
            args.plot,
            title="Progressive RD sweep",
        )
    return result


if __name__ == "__main__":
    main()
