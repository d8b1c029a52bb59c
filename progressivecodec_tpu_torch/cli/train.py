"""Training CLI: data -> model -> dual optimisers -> epochs of training,
validation, the plateau lr schedule, checkpoints and periodic evals.

Counterpart of `progressivecodec_tpu/cli/train.py`, with the same flags
plus --device (default cuda; without a card the run raises unless given
--device cpu).  Per epoch: the train steps (noise seeded seed*1000 +
epoch, the losses kept on the device until the epoch ends), validation at
qualities (0, 10), which drives the plateau schedule and the best
checkpoint, `ckpt_last` (and `ckpt_best`) saved before the heavy evals,
then every --eval-every epochs the 14-point entropy-estimate sweep and the
real-codec eval at (0, 1, 10) on the card's kernels, each eval on a fresh
codec.  A failed eval is logged as an `eval_error` record, retried, and
skipped.  Records go to `<out>/metrics.jsonl`; a resumed run (--checkpoint)
continues the epoch numbering, the best loss and the plateau.

Usage:
  python -m progressivecodec_tpu_torch.cli.train --train-dir DIR --test-dir DIR \\
      [--config cfg.json] [--epochs N] [--out runs/exp1] [--synthetic] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig, TrainConfig
from progressivecodec_tpu_torch.data.datasets import (
    ImageFolderDataset,
    KodakDataset,
    NaturalSyntheticDataset,
    PatchLoader,
    SyntheticDataset,
    SyntheticKodak,
)
from progressivecodec_tpu_torch.device import resolve_device, set_deterministic
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.ops.noise import NoiseSource
from progressivecodec_tpu_torch.parallel.distributed import process_index_count
from progressivecodec_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval, evaluate_codec
from progressivecodec_tpu_torch.training.optim import (
    PlateauState,
    plateau_init,
    plateau_update,
    set_lr_scale,
)
from progressivecodec_tpu_torch.training.step import (
    init_train_state,
    make_sampled_train_step,
    make_train_step,
)
from progressivecodec_tpu_torch.utils.rd import (
    BASE_ANCHOR_BPP,
    BASE_ANCHOR_PSNR,
    plot_rd,
    rd_curve_dict,
)

TEST_SWEEP = (0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 10.0)
REAL_QUALITIES = (0.0, 1.0, 10.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the progressive codec (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help="ModelConfig JSON file")
    p.add_argument("--train-dir", type=str, default=None)
    p.add_argument("--test-dir", type=str, default=None)
    p.add_argument("--out", type=str, default="runs/default")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lr-patience", type=int, default=None, dest="lr_patience")
    p.add_argument("--checkpoint", type=str, default=None, help="resume path")
    p.add_argument("--synthetic", action="store_true", help="synthetic data (smoke)")
    p.add_argument("--natural", action="store_true",
                   help="natural-statistics synthetic training data with the synthetic-Kodak "
                   "test set")
    p.add_argument("--natural-n", type=int, default=4000, help="train set size for --natural")
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--sampled", action="store_true",
                   help="sampled single-quality training instead of the joint ladder")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _log(out_dir, record):
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)


def _try_eval(out_dir, epoch, what, fn, retries: int = 2):
    """Containment for the periodic evals: a failure is logged as an
    `eval_error` record and retried, and the run goes on without the eval
    if every attempt failed."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - deliberate containment, logged
            _log(out_dir, {"epoch": epoch, "eval_error": what, "attempt": attempt,
                           "error": f"{type(e).__name__}: {e}"[:500]})
            time.sleep(5.0 * (attempt + 1))
    return None


def _datasets(args, tcfg: TrainConfig):
    """(train set, test images, validation images or None)."""
    if args.natural:
        kodak = SyntheticKodak()
        # validation (seed 1) is held out from training (seed 0): the
        # plateau schedule must see validation loss
        valid = NaturalSyntheticDataset(n=4, size=256, seed=1)
        return (NaturalSyntheticDataset(n=args.natural_n, size=max(384, tcfg.patch_size)),
                [kodak[i] for i in range(len(kodak))], [valid[i] for i in range(len(valid))])
    if args.synthetic:
        return (SyntheticDataset(n=max(64, tcfg.batch_size * 4), size=tcfg.patch_size),
                [SyntheticDataset(n=2, size=256)[i] for i in range(2)], None)
    # each process of a multi-process run reads its own stripe of the files
    host, hosts = process_index_count()
    train = ImageFolderDataset(args.train_dir, "train", tcfg.num_images, host_index=host,
                               host_count=hosts)
    kodak = KodakDataset(args.test_dir)
    return train, [kodak[i] for i in range(len(kodak))], None


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_deterministic()
    if device.type == "cuda":  # a kernel that does not build stops the run before step 1
        from progressivecodec_tpu_torch import build

        build.build()
    os.makedirs(args.out, exist_ok=True)

    mcfg = ModelConfig()
    if args.config:
        with open(args.config) as f:
            mcfg = config_lib.model_config_from_json(f.read())
    overrides = {k: getattr(args, k) for k in ("epochs", "batch_size", "lr", "seed", "lr_patience")
                 if getattr(args, k) is not None}
    tcfg = dataclasses.replace(TrainConfig(), **overrides)
    train_ds, test_imgs, valid_imgs = _datasets(args, tcfg)

    model = get_model(mcfg, device=device)
    model.load_state_dict(init_params(mcfg, torch.Generator().manual_seed(tcfg.seed)), strict=True)
    state = init_train_state(model, tcfg)
    start_epoch, resumed = 0, {}
    if args.checkpoint:
        state, meta = load_checkpoint(args.checkpoint, state)
        resumed = meta.get("extra", {}) or {}
        # a resumed run continues the same epoch series in metrics.jsonl
        start_epoch = int(resumed.get("epoch", -1)) + 1
        print(f"resumed from {args.checkpoint} at step {state.step} epoch {start_epoch}",
              flush=True)

    step_fn = make_sampled_train_step() if args.sampled else make_train_step((0, 10))
    loader = PatchLoader(train_ds, tcfg.batch_size, tcfg.patch_size, seed=tcfg.seed,
                         workers=8 if args.natural else 2)
    plateau, best_loss = plateau_init(), float("inf")
    if resumed:
        best_loss = float(resumed.get("best_loss", best_loss))
        p = resumed.get("plateau")
        if p:
            plateau = PlateauState(best=float(p["best"]), bad_epochs=int(p["bad_epochs"]),
                                   scale=float(p["scale"]))
            set_lr_scale(state.opt, plateau.scale)

    for epoch in range(start_epoch, tcfg.epochs):
        t0 = time.time()
        losses = []
        noise = NoiseSource.seeded(tcfg.seed * 1000 + epoch, device)
        for bi, batch in enumerate(loader.epoch(epoch)):
            if args.steps_per_epoch and bi >= args.steps_per_epoch:
                break
            x = torch.from_numpy(batch).to(device)
            state, metrics = step_fn(state, x, noise)
            losses.append(metrics["loss_total"])  # stays on the device
        train_loss = (float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                      if losses else float("nan"))
        _log(args.out, {"epoch": epoch, "step": state.step, "train_loss": train_loss,
                        "time_s": time.time() - t0})

        # validation at (0, 10): the loss of the plateau schedule and of the
        # best checkpoint; a fresh codec, since the weights moved
        codec = make_codec(model, device=device)
        vimgs = valid_imgs if valid_imgs is not None else test_imgs[:4]
        val = _try_eval(args.out, epoch, "valid", lambda: entropy_estimate_eval(
            codec, vimgs, pr_list=(0.0, 10.0), lmbda_list=mcfg.lmbda_list))
        if val is not None:
            _log(args.out, {"epoch": epoch, "valid": val})
        # train loss only when every validation attempt failed
        plateau_metric = val["loss"] if val is not None else train_loss
        new_plateau = plateau_update(plateau, plateau_metric, tcfg.lr_factor, tcfg.lr_patience)
        if new_plateau.scale != plateau.scale:
            set_lr_scale(state.opt, new_plateau.scale)
            _log(args.out, {"epoch": epoch, "lr_scale": new_plateau.scale,
                            "lr": tcfg.lr * new_plateau.scale})
        plateau = new_plateau
        best_loss = min(best_loss, plateau_metric)
        extra = {"epoch": epoch, "best_loss": best_loss,
                 "plateau": {"best": plateau.best, "bad_epochs": plateau.bad_epochs,
                             "scale": plateau.scale}}
        # checkpoints before the heavy evals: a kill there costs the evals,
        # not the epoch
        save_checkpoint(os.path.join(args.out, "ckpt_last"), state, mcfg, tcfg, extra=extra)
        if plateau_metric <= best_loss:
            save_checkpoint(os.path.join(args.out, "ckpt_best"), state, mcfg, tcfg, extra=extra)

        if (epoch + 1) % args.eval_every == 0:
            test = _try_eval(args.out, epoch, "test", lambda: entropy_estimate_eval(
                codec, test_imgs[:4], pr_list=TEST_SWEEP))
            if test is not None:
                _log(args.out, {"epoch": epoch, "test": test})

            def _real_eval():
                codec.update()
                return evaluate_codec(codec, test_imgs[:4], pr_list=REAL_QUALITIES)

            real = _try_eval(args.out, epoch, "real_codec", _real_eval)
            if real is not None:
                _log(args.out, {"epoch": epoch, "real_codec": real})
                curves = [rd_curve_dict(BASE_ANCHOR_BPP, BASE_ANCHOR_PSNR, "reference base anchor"),
                          rd_curve_dict(real["bpp"], real["psnr"], "ours")]
                plot_rd(curves, os.path.join(args.out, f"rd_epoch{epoch}.png"))


if __name__ == "__main__":
    main()
