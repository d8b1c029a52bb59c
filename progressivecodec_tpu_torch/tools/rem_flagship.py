"""REM at flagship scale: bank training from a flagship checkpoint, judged
by the real codec.

Counterpart of tools/rem_flagship.py (the reference's workflow:
CHProgREM.py:299-304 trains only the banks; their purpose:
CHProgREM.py:205-234).  From a checkpoint of the port's trainer holding a
progressive model (the flagship's stacked layout, or unrolled):
  1. REM on it: `dataclasses.replace(cfg, name="rate", stack_prog=False)`
     with the lmbda log-interpolated from the checkpoint's first to its last
     over the four levels of the REM quality ladder (q=0 and the three
     interval midpoints), the banks from `init_params` (seed 1), then the
     checkpoint's weights by `load_state_dict(strict=False)`, whose missing
     keys must be exactly the banks' (`post_latent.*`).  The stacked and the
     unrolled model name their modules alike, so no unstacking is needed
     (JAX's `torch_import.unstack_prog_params`);
  2. the real codec (`evaluate_codec`, `GranularCodec(lanes=512,
     lane_policy="auto")`) on `--n-images` SyntheticKodak images at the
     interval midpoints, for the frozen base (the checkpoint's weights in the
     unrolled progressive model) and for REM before training: the banks
     start as the identity (`zero_out` is zero at init), so the two must
     agree exactly (`identity_at_init`), or the tool raises;
  3. the banks alone (`training/freeze.rem_freeze_fn`, `masked_optimizer`)
     trained `--bank-steps` steps at the midpoints on natural-statistics
     synthetic patches (`--batch-size`, `--patch-size`, `--lr`); every other
     parameter must stay as it was, bit for bit;
  4. the real codec again, and the before / after / delta JSON to `--out`
     with the keys of JAX's runs/rem_flagship.json.
JAX's `--cpu` is `--device cpu` here.  On the card the record carries the
card's name and power limit.

Usage:
    python -m progressivecodec_tpu_torch.tools.rem_flagship --checkpoint runs/exp1/ckpt_best
        [--bank-steps 1500] [--batch-size 16] [--patch-size 256] [--lr 1e-4]
        [--n-images 8] [--out rem_flagship.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from progressivecodec_tpu_torch.data.datasets import (
    NaturalSyntheticDataset,
    PatchLoader,
    SyntheticKodak,
)
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.rem import BANKS, PostRateProcessedNetwork
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.tools.profile_codec import seeded_model
from progressivecodec_tpu_torch.tools.rd_ladder import load_checkpoint_model
from progressivecodec_tpu_torch.tools.rem_demo import same_rd, train_banks, transplant
from progressivecodec_tpu_torch.training.evaluate import evaluate_codec

RD_KEYS = ("bpp", "psnr", "ms_ssim_db")


def rem_config(cfg):
    """REM's configuration on a progressive checkpoint's: unrolled banks, and
    one lmbda per level of the ladder [0] + interval midpoints (4 levels),
    log-interpolated from the checkpoint's first lmbda to its last (the
    scalable RD loss pairs them elementwise, training/loss.py)."""
    lo, hi = float(cfg.lmbda_list[0]), float(cfg.lmbda_list[-1])
    lmb = [float(np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * t))
           for t in (0.0, 1.0 / 3, 2.0 / 3, 1.0)]
    return dataclasses.replace(cfg, name="rate", stack_prog=False, lmbda_list=tuple(lmb))


def real_eval(model, images, qualities):
    codec = GranularCodec(model, lanes=512, lane_policy="auto",
                          device=next(model.parameters()).device)
    codec.update()
    return evaluate_codec(codec, images, pr_list=qualities)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--bank-steps", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-images", type=int, default=8, help="eval image count")
    p.add_argument("--out", type=str, default="rem_flagship.json")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    t_start = time.time()
    dev = resolve_device(args.device)
    base, base_cfg, step = load_checkpoint_model(args.checkpoint, dev)
    base_state = base.state_dict()
    del base
    print(f"loaded {base_cfg.name} from {args.checkpoint} (step {step})", flush=True)

    # 1. REM on the checkpoint
    rem_cfg = rem_config(base_cfg)
    rem = seeded_model(rem_cfg, dev, 1)
    transplant(base_state, rem)
    mid_qs = tuple(PostRateProcessedNetwork.init_qualities(rem_cfg)[1:])
    n_bank = sum(p.numel() for n, p in rem.named_parameters() if n.startswith(BANKS))
    print(f"interval midpoints {mid_qs}, lmbdas {list(rem_cfg.lmbda_list)}, "
          f"bank parameters {n_bank / 1e6:.1f}M", flush=True)

    # 2. the frozen base (unrolled, no banks) and REM at init, real codec
    kodak = SyntheticKodak()
    imgs = [kodak[i] for i in range(min(args.n_images, len(kodak)))]
    frozen = get_model(dataclasses.replace(base_cfg, stack_prog=False), device=dev)
    frozen.load_state_dict(base_state, strict=True)
    frozen_eval = real_eval(frozen, imgs, mid_qs)
    del frozen, base_state
    before = real_eval(rem, imgs, mid_qs)
    print("frozen base @ midpoints:", json.dumps(frozen_eval), flush=True)
    if not same_rd(before, frozen_eval, RD_KEYS):
        raise RuntimeError(f"REM with identity banks differs from its base: {before}")

    # 3. the banks alone
    ds = NaturalSyntheticDataset(n=4000, size=max(384, args.patch_size))
    loader = PatchLoader(ds, args.batch_size, args.patch_size, seed=7, workers=8)
    t0 = time.time()
    losses, moved = train_banks(rem, loader, args.bank_steps, mid_qs, args.lr, 11)
    loss_head, loss_tail = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    print(f"bank loss {loss_head:.2f} -> {loss_tail:.2f} over {args.bank_steps} steps "
          f"({(time.time() - t0) / max(args.bank_steps, 1):.2f} s/step), {moved} bank tensors "
          "moved", flush=True)
    if args.bank_steps and not moved:
        raise RuntimeError("bank training moved no bank parameter")

    # 4. after
    after = real_eval(rem, imgs, mid_qs)
    print("REM after bank training:", json.dumps(after), flush=True)
    deltas = {
        "psnr_db": [round(a - b, 4) for a, b in zip(after["psnr"], before["psnr"])],
        "bpp_pct": [round(100.0 * (a - b) / max(b, 1e-9), 3)
                    for a, b in zip(after["bpp"], before["bpp"])],
    }
    out = {
        "protocol": {
            "checkpoint": args.checkpoint, "step": step, "bank_steps": args.bank_steps,
            "batch": args.batch_size, "patch": args.patch_size,
            "mid_qualities": list(mid_qs), "lmbda_list": list(rem_cfg.lmbda_list),
            "frozen": "everything except post_latent banks (rem_freeze_fn)",
            "eval": f"REAL codec on {len(imgs)} synthetic-Kodak 768x512",
            "identity_at_init": "zero_out => before == frozen base exactly (checked)",
        },
        "frozen_base": frozen_eval,
        "rem_before_bank_training": before,
        "rem_after_bank_training": after,
        "delta": deltas,
        "bank_loss_head_tail": [loss_head, loss_tail],
        "identity_at_init": True, "frozen_unchanged": True, "bank_tensors_moved": moved,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_s": round(time.time() - t_start, 1),
    }
    if dev.type == "cuda":
        out["nvidia_smi"] = card_line()
    with open(args.out, "w") as f:
        f.write(json.dumps(out, indent=2))
    print("wrote", args.out, flush=True)
    print(json.dumps(deltas), flush=True)
    return out


if __name__ == "__main__":
    main()
