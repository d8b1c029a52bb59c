"""Parameter freezing by module.

Counterpart of `progressivecodec_tpu/training/freeze.py`.  JAX's filters
take the top-level module names of its parameter tree (`g_a0`, `cc_mean`,
`h_mean_s0`, `post_latent0_3`, ...); the port's modules carry the
reference's names (`g_a.0.`, `cc_mean_transforms.`, `h_mean_s.0.`,
`post_latent.0.3.`, ...).  `jax_module_name` maps one onto the other, so
the filters are JAX's own.  A frozen parameter gets `requires_grad=False`:
it takes no gradient and stays out of both optimisers and the clip norm.
"""

from __future__ import annotations

from typing import Callable

import torch

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.training.optim import Optimizers

BASE_NET_MODULES = ("g_a0", "g_s0", "cc_mean", "cc_scale", "lrp")
BASE_HYPER_MODULES = ("h_mean_s0", "h_scale_s0")

# port module -> JAX top-level name.  An indexed entry names its member
# `{name}{i}` when the configuration flag is set (two of them), and the
# whole module `{name}` otherwise; "always" members are always indexed.
_MODULES = {
    "g_a": ("g_a", "multiple_encoder"),
    "g_s": ("g_s", "multiple_decoder"),
    "h_mean_s": ("h_mean_s", "multiple_hyperprior"),
    "h_scale_s": ("h_scale_s", "multiple_hyperprior"),
    "h_a": ("h_a", None),
    "entropy_bottleneck": ("entropy_bottleneck", None),
    "cc_mean_transforms": ("cc_mean", None),
    "cc_scale_transforms": ("cc_scale", None),
    "lrp_transforms": ("lrp", None),
    "cc_mean_transforms_prog": ("cc_mean_prog", None),
    "cc_scale_transforms_prog": ("cc_scale_prog", None),
    "lrp_transforms_prog": ("lrp_prog", None),
    "joiner": ("joiner", "always"),
    "refine": ("refine", "u_net_post"),
}


def jax_module_name(name: str, cfg: ModelConfig) -> str:
    """Top-level JAX module of the port parameter `name`."""
    parts = name.split(".")
    if parts[0] == "masking":  # masking.mask_conv.{i}.
        return f"mask_conv{parts[2]}"
    if parts[0] == "post_latent":  # post_latent.{k}.{i}.
        return f"post_latent{parts[1]}_{parts[2]}"
    jax_name, flag = _MODULES[parts[0]]
    if flag == "always":
        indexed = True
    elif flag == "u_net_post":
        indexed = cfg.u_net_post == 2
    else:
        indexed = flag is not None and cfg.name != "cnn" and getattr(cfg, flag)
    return f"{jax_name}{parts[1]}" if indexed else jax_name


def freeze_base_net_fn(multiple_hyperprior: bool = False, freeze_dec: bool = False):
    """Trainable filter of freeze_base_net: the base encoder, decoder and
    ChARM banks (and the base hyperprior, or the enhancement decoder) are
    frozen."""
    frozen = set(BASE_NET_MODULES)
    if multiple_hyperprior:
        frozen |= set(BASE_HYPER_MODULES)
    if freeze_dec:
        frozen.add("g_s1")
    return lambda name: name not in frozen


def rem_freeze_fn():
    """REM training: only the post_latent banks learn."""
    return lambda name: name.startswith("post_latent")


def decoder_only_fn():
    """unfreeze_decoder: only g_s learns."""
    return lambda name: name.startswith("g_s")


def freeze(model: torch.nn.Module, trainable_fn: Callable[[str], bool]) -> None:
    """requires_grad = trainable_fn(JAX module name) for every parameter."""
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable_fn(jax_module_name(name, model.cfg))))


def masked_optimizer(model: torch.nn.Module, trainable_fn: Callable[[str], bool],
                     lr: float = 1e-4, aux_lr: float = 1e-3,
                     clip_max_norm: float = 1.0) -> Optimizers:
    """Freeze by `trainable_fn`, then the optimisers of what still learns."""
    freeze(model, trainable_fn)
    return Optimizers(model, lr, aux_lr, clip_max_norm)
