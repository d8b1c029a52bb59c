"""Train and eval steps.

Counterpart of `progressivecodec_tpu/training/step.py`.  One step is one
forward at the quality ladder, one backward of RD loss + aux loss, then
both optimisers (training/optim.py): the quantiles take the gradient of the
total, the other parameters that of the RD loss, as JAX's
`multi_transform` gives them.  The metrics stay on the device, so a step
never waits for the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from progressivecodec_tpu_torch.config import TrainConfig
from progressivecodec_tpu_torch.training.loss import scalable_rate_distortion_loss
from progressivecodec_tpu_torch.training.optim import Optimizers


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: Optimizers
    step: int = 0


def init_train_state(model: torch.nn.Module, train_cfg: TrainConfig) -> TrainState:
    """The model's optimisers at the configuration's lrs and clip, step 0."""
    return TrainState(model, Optimizers(model, train_cfg.lr, train_cfg.aux_lr,
                                        train_cfg.clip_max_norm))


def train_loss(model, batch: torch.Tensor, quality=(0, 10), mask_pol: str | None = None,
               noise=None):
    """The training forward and its objective -> (RD loss + aux loss,
    metrics): loss, bpp_loss, bpp_base, bpp_scalable, bpp_hyper, aux_loss,
    mse_first and mse_last."""
    out = model(batch, list(quality), mask_pol, training=True, noise=noise)
    aux = model.entropy_bottleneck.aux_loss()
    losses = scalable_rate_distortion_loss(out, batch, model.cfg.lmbda_list)
    metrics = {k: v for k, v in losses.items() if k != "mse"}
    metrics["aux_loss"] = aux
    metrics["mse_first"] = losses["mse"][0]
    metrics["mse_last"] = losses["mse"][-1]
    return losses["loss"] + aux, metrics


def make_train_step(quality=(0, 10), mask_pol: str | None = None):
    """-> step(state, batch, noise) -> (state, metrics): the joint
    multi-quality objective at `quality`, noise drawn from `noise`
    (ops/noise.py).  The state is updated in place; the metrics, with
    loss_total, are detached device tensors."""

    def step(state: TrainState, batch: torch.Tensor, noise):
        state.opt.zero_grad()
        total, metrics = train_loss(state.model, batch, quality, mask_pol, noise)
        total.backward()
        state.opt.step()
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        metrics["loss_total"] = total.detach()
        return state, metrics

    return step


def make_sampled_train_step(qualities=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
                            mask_pol: str | None = None):
    """Sampled single-quality training: each batch trains at (0, q), q drawn
    on the host from `qualities` by np.random.default_rng(0)."""
    steps = {q: make_train_step((0, q), mask_pol) for q in qualities}
    host_rng = np.random.default_rng(0)

    def step(state: TrainState, batch: torch.Tensor, noise):
        q = qualities[int(host_rng.integers(0, len(qualities)))]
        return steps[q](state, batch, noise)

    return step


def make_eval_step(quality: float, mask_pol: str | None = None):
    """-> step(model, batch) -> {"bpp" (likelihood estimate), "mse", "psnr",
    "x_hat"} of the eval forward at one quality."""

    @torch.no_grad()
    def step(model, batch: torch.Tensor) -> dict:
        out = model.forward_single_quality(batch, quality, mask_pol)
        b, h, w, _ = batch.shape
        denom = -math.log(2) * (b * h * w)
        lik = out["likelihoods"]
        bpp = torch.sum(torch.log(lik["y"])) / denom + torch.sum(torch.log(lik["z"])) / denom
        mse = torch.mean((out["x_hat"] - batch) ** 2)
        psnr = -10.0 * torch.log10(mse + 1e-12)
        return {"bpp": bpp, "mse": mse, "psnr": psnr, "x_hat": out["x_hat"]}

    return step
