"""REM doing its job: the rate-enhancement banks trained between checkpoints.

Counterpart of tools/rem_demo.py (the reference's rationale:
CHProgREM.py:205-234, refine the entropy parameters of the enhancement
slices between the discrete checkpoint qualities with the base frozen):
  1. trains a TINY unrolled progressive base (stack_prog=False, the layout
     REM's per-slice banks need) on natural-statistics synthetic patches
     for REM_DEMO_BASE_STEPS steps (default 300) at qualities (0, 10);
  2. transplants it into REM, `ModelConfig(name="rate", lmbda_list=(0.0055,
     0.0075, 0.02, 0.075), **TINY)`: a `load_state_dict(strict=False)` whose
     missing keys must be exactly the banks' (`post_latent.*`);
  3. freezes everything but the banks (`training/freeze.rem_freeze_fn`,
     `masked_optimizer`) and trains them at the interval midpoints
     MID_QS = (0.1, 1.0, 5.0) for REM_DEMO_BANK_STEPS steps (default 200);
  4. writes the entropy-estimate eval (`entropy_estimate_eval`) at MID_QS of
     the base, of REM before and of REM after the bank training to `--out`
     with the keys of JAX's runs/rem_demo.json.
The banks start as the identity (`zero_out` is zero at init), so REM before
training must equal the base exactly (`identity_at_init`); the bank steps
must leave every other parameter as it was, bit for bit
(`frozen_unchanged`), and move the banks (`bank_tensors_moved`).  Each is
checked, and a failure raises.  The noise comes from a seeded
`NoiseSource`; the weights from `init_params` (seeds 0 and 1).  On the card
the record carries the card's name and power limit.

Usage:
    REM_DEMO_BASE_STEPS=300 REM_DEMO_BANK_STEPS=200 \\
        python -m progressivecodec_tpu_torch.tools.rem_demo [--out rem_demo.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.data.datasets import NaturalSyntheticDataset, PatchLoader
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.rem import BANKS
from progressivecodec_tpu_torch.ops.noise import NoiseSource
from progressivecodec_tpu_torch.tools.bench_coder import card_line
from progressivecodec_tpu_torch.tools.profile_codec import seeded_model
from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval
from progressivecodec_tpu_torch.training.freeze import masked_optimizer, rem_freeze_fn
from progressivecodec_tpu_torch.training.step import (
    TrainState,
    init_train_state,
    make_train_step,
)

# interval midpoints of check_levels (0.01, 0.25, 1.75): the qualities at
# which the banks act
MID_QS = (0.1, 1.0, 5.0)
# the same lmbda weighting for every eval, so the losses compare
EVAL_LMBDAS = (0.0055, 0.02, 0.075)
TINY = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
            scale_table=ScaleTableConfig(levels=32), check_levels=(0.01, 0.25, 1.75),
            stack_prog=False)


def transplant(base_state: dict, rem_model) -> None:
    """Load a progressive model's state dict into REM: every key must land,
    and only the banks (`post_latent.*`) may be left as they were."""
    missing, unexpected = rem_model.load_state_dict(base_state, strict=False)
    banks = {n for n, _ in rem_model.named_parameters() if n.startswith(BANKS)}
    if unexpected or set(missing) != banks:
        raise ValueError(f"transplant: unexpected keys {unexpected[:5]}, missing keys other than "
                         f"the banks {sorted(set(missing) - banks)[:5]}, banks not missing "
                         f"{sorted(banks - set(missing))[:5]}")


def train(state: TrainState, step_fn, loader, n_steps: int, noise) -> list[float]:
    """`n_steps` steps over the loader's epochs; the loss of each step."""
    losses, epoch = [], 0
    dev = next(state.model.parameters()).device
    while len(losses) < n_steps:
        for batch in loader.epoch(epoch):
            if len(losses) >= n_steps:
                break
            state, metrics = step_fn(state, torch.from_numpy(batch).to(dev), noise)
            losses.append(metrics["loss_total"])
        epoch += 1
    return [float(v) for v in losses]


def train_banks(rem_model, loader, n_steps: int, quality, lr: float, seed: int):
    """Train only REM's banks -> (losses, bank tensors that moved); raises
    if any other parameter changed."""
    before = {n: p.detach().clone() for n, p in rem_model.named_parameters()}
    state = TrainState(rem_model, masked_optimizer(rem_model, rem_freeze_fn(), lr=lr))
    dev = next(rem_model.parameters()).device
    losses = train(state, make_train_step(quality=quality), loader, n_steps,
                   NoiseSource.seeded(seed, dev))
    changed = [n for n, p in rem_model.named_parameters() if not torch.equal(p, before[n])]
    frozen = [n for n in changed if not n.startswith(BANKS)]
    if frozen:
        raise RuntimeError(f"bank training changed frozen parameters: {frozen[:5]}")
    return losses, len(changed)


def same_rd(a: dict, b: dict, keys=("bpp", "psnr")) -> bool:
    return all(a[k] == b[k] for k in keys)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="rem_demo.json")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    base_steps = int(os.environ.get("REM_DEMO_BASE_STEPS", 300))
    bank_steps = int(os.environ.get("REM_DEMO_BANK_STEPS", 200))

    t_start = time.time()
    dev = resolve_device(args.device)
    tcfg = TrainConfig(batch_size=8, patch_size=64)
    loader = PatchLoader(NaturalSyntheticDataset(n=256, size=96), tcfg.batch_size,
                         tcfg.patch_size, seed=0, workers=2)
    valid_ds = NaturalSyntheticDataset(n=2, size=128, seed=1)
    valid = [valid_ds[i] for i in range(2)]

    # 1. the TINY progressive base
    base = seeded_model(ModelConfig(name="channel", **TINY), dev, 0)
    base_losses = train(init_train_state(base, tcfg), make_train_step(quality=(0, 10)), loader,
                        base_steps, NoiseSource.seeded(10, dev))
    print(f"base trained {base_steps} steps: loss {base_losses[0]:.1f} -> "
          f"{np.mean(base_losses[-20:]):.1f}", flush=True)
    base_eval = entropy_estimate_eval(GranularCodec(base, lanes=64, device=dev), valid,
                                      pr_list=MID_QS, lmbda_list=EVAL_LMBDAS)
    print("base RD:", json.dumps(base_eval), flush=True)

    # 2. REM on the base: one lmbda per level of the quality ladder, which the
    # forward starts with the base (q=0): 4 levels, 4 lmbdas
    rem_cfg = ModelConfig(name="rate", lmbda_list=(0.0055, 0.0075, 0.02, 0.075), **TINY)
    rem = seeded_model(rem_cfg, dev, 1)
    transplant(base.state_dict(), rem)
    rem_before = entropy_estimate_eval(GranularCodec(rem, lanes=64, device=dev), valid,
                                       pr_list=MID_QS, lmbda_list=EVAL_LMBDAS)
    print("REM before bank training:", json.dumps(rem_before), flush=True)
    if not same_rd(rem_before, base_eval, ("bpp", "psnr", "loss")):
        raise RuntimeError("REM with identity banks differs from its base")

    # 3. the banks alone, at the interval midpoints
    bank_losses, moved = train_banks(rem, loader, bank_steps, MID_QS, 1e-4, 20)
    print(f"banks trained {bank_steps} steps: loss {bank_losses[0]:.1f} -> "
          f"{np.mean(bank_losses[-20:]):.1f}, {moved} bank tensors moved", flush=True)
    if bank_steps and not moved:
        raise RuntimeError("bank training moved no bank parameter")
    rem_after = entropy_estimate_eval(GranularCodec(rem, lanes=64, device=dev), valid,
                                      pr_list=MID_QS, lmbda_list=EVAL_LMBDAS)
    print("REM after bank training:", json.dumps(rem_after), flush=True)

    out = {
        "protocol": {
            "base_steps": base_steps, "bank_steps": bank_steps, "mid_qualities": MID_QS,
            "config": "TINY N=32 M=64", "frozen": "everything except post_latent banks (rem_freeze_fn)",
        },
        "base": base_eval,
        "rem_before_bank_training": rem_before,
        "rem_after_bank_training": rem_after,
        "loss_improvement_vs_base": base_eval["loss"] - rem_after["loss"],
        "identity_at_init": True, "frozen_unchanged": True, "bank_tensors_moved": moved,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_s": round(time.time() - t_start, 1),
    }
    if dev.type == "cuda":
        out["nvidia_smi"] = card_line()
    with open(args.out, "w") as f:
        f.write(json.dumps(out, indent=2))
    print(f"wrote {args.out}; loss improvement vs base: {out['loss_improvement_vs_base']}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
