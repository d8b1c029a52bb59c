"""Eval CLI: real-codec and entropy-estimate metrics over a dataset at a
quality ladder, printed (and written with --out) as JSON.

Counterpart of `progressivecodec_tpu/cli/eval.py`.  With --checkpoint it
evaluates the weights of a checkpoint of the port's trainer (`cli/train.py`)
on the configuration in its config.json; without, the flagship
`ModelConfig()` with seeded random weights (`init_params`, seed 0).
--device picks the card (default cuda) or the CPU.

Usage:
  python -m progressivecodec_tpu_torch.cli.eval --synthetic --max-images 1 \\
      --qualities 0,5,10 [--device cuda] [--out results.json]
  python -m progressivecodec_tpu_torch.cli.eval --checkpoint runs/exp1/ckpt_best \\
      --dataset /path/to/kodak
"""

from __future__ import annotations

import argparse
import json

import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.data.datasets import KodakDataset, SyntheticDataset
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.training.checkpoint import read_checkpoint
from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval, evaluate_codec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--qualities", type=str, default="0,1,2,4,6,8,10")
    p.add_argument("--mask-pol", type=str, default=None)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    pr_list = [float(q) for q in args.qualities.split(",")]

    if args.checkpoint:
        payload, meta = read_checkpoint(args.checkpoint)
        mcfg = config_lib.model_config_from_json(json.dumps(meta["model"]))
        weights = payload["model"]
    else:
        mcfg = ModelConfig()
        weights = init_params(mcfg, torch.Generator().manual_seed(0))
    model = get_model(mcfg, device=args.device)
    model.load_state_dict(weights, strict=True)

    ds = SyntheticDataset(n=4, size=256) if args.synthetic else KodakDataset(args.dataset)
    images = [ds[i] for i in range(len(ds))]
    if args.max_images:
        images = images[: args.max_images]

    codec = make_codec(model, device=args.device)
    codec.update()
    real = evaluate_codec(codec, images, pr_list=pr_list, mask_pol=args.mask_pol)
    est = entropy_estimate_eval(codec, images, pr_list=pr_list, mask_pol=args.mask_pol)
    dev = codec.device
    result = {"qualities": pr_list, "real_codec": real, "entropy_estimate": est,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type}
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
