"""MaskEstractor training: predict gradient importance maps from latents.

Counterpart of `progressivecodec_tpu/training/mask_trainer.py`.  The
features are the eval forward's base and minimal-enhancement latents and
their (mu | std) entropy parameters; the target is `importance_map`; one
train step is an MSE regression with Adam at optax's settings (b1 0.9, b2
0.999, eps 1e-8, no clip, no weight decay).
"""

from __future__ import annotations

import math

import torch

from progressivecodec_tpu_torch.layers.importance import MaskEstractor, importance_map

F32 = torch.float32


@torch.no_grad()
def mask_features(model, x, q_eps: float = 1e-6):
    """(y_base, y_p0, params_base, params_p0), channel-last: the base
    latent, the minimal-enhancement latent, and the (mu | std) of each.  As
    in JAX, they are constants of the train step."""
    out_b = model.forward_single_quality(x, 0.0, "point-based-std", training=False)
    out_e = model.forward_single_quality(x, q_eps, "point-based-std", training=False)
    params_base = torch.cat([out_b["mu"], out_b["std"]], dim=-1)
    params_p0 = torch.cat([out_e["mu"], out_e["std"]], dim=-1)
    return out_b["y_hat"], out_e["y_hat"], params_base, params_p0


def mask_feature_widths(cfg) -> tuple[int, int, int, int]:
    """Channels of `mask_features`' four outputs for the model `cfg` names."""
    enh = cfg.num_prog_slices * cfg.dim_chunk
    return cfg.division_channel, enh, 2 * cfg.division_channel, 2 * enh


@torch.no_grad()
def init_mask_estractor(generator: torch.Generator, model, n: int | None = None) -> MaskEstractor:
    """A MaskEstractor for `model` (n defaults to the division channel) on
    the model's device, with Kaiming-normal (fan_out) convs and zero biases
    drawn from `generator`, as `models/weights.py:init_params` draws convs.
    The numbers differ from JAX's for the same seed."""
    cfg = model.cfg
    device = next(model.parameters()).device
    est = MaskEstractor(n or cfg.division_channel, *mask_feature_widths(cfg), device=device)
    for mod in est.modules():
        if isinstance(mod, torch.nn.Conv2d):
            o, _, kh, kw = mod.weight.shape
            std = math.sqrt(2.0 / (kh * kw * o))
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator, dtype=F32) * std)
            mod.bias.zero_()
    return est


def make_mask_train_step(est: MaskEstractor, lr: float = 1e-4):
    """(optimizer, step): step(feats, target_map) runs one MSE regression
    step of `est` in place and returns the loss before the update."""
    opt = torch.optim.Adam(est.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(feats, target_map) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((est(*feats) - target_map) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, step


@torch.no_grad()
def predict_cust_map(est: MaskEstractor, model, x) -> torch.Tensor:
    """The decoder-side map: the estractor on codec-derivable features."""
    return est(*mask_features(model, x))


def importance_target(model, x, noise, scale_table) -> torch.Tensor:
    """The ground-truth |grad| x |delta| map (ImportanceMapDataset's label)."""
    return importance_map(model, x, noise, scale_table)
