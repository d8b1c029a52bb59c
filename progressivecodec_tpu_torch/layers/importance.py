"""Gradient importance maps and the MaskEstractor that learns to predict them.

Counterpart of `progressivecodec_tpu/layers/importance.py`.  The map scores
each element of the base latent by |d(synthesis MSE)/d latent| times
|delta latent| between a base draw and a minimal-enhancement draw; a
MaskEstractor learns to predict it from features the decoder has, so that
encoder and decoder can share it as the enhancement mask's ranking
(`cust_map`).

The two latent draws come from a noise source (`ops/noise.py`), asked for
in JAX's order and shapes: the base draw, then the enhancement draw, each
channel-last.  Everything here is channel-last, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from progressivecodec_tpu_torch.models.rem import ResidualBlock
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc

F32 = torch.float32


def snap_to_scale_table(scales: torch.Tensor, scale_table) -> torch.Tensor:
    """relu, then snap each sigma UP to the first table entry at or above it
    (the last entry above the table), as the entropy model's indexes do."""
    scales = torch.relu(scales.to(F32))
    table = torch.as_tensor(np.asarray(scale_table), dtype=F32, device=scales.device)
    # JAX's index (L - 1) - #{j < L - 1 : s <= t_j} is the count of t_j < s
    return table[torch.searchsorted(table[:-1], scales.contiguous(), side="left")]


def importance_map(model, x_padded: torch.Tensor, noise, scale_table,
                   q_eps: float = 1e-6) -> torch.Tensor:
    """|grad| * |y_b - y_e| for the enhancement layer, shaped like the base
    latent (B, h, w, C), channel-last.  `model` is a progressive model on
    x_padded's device; `noise` supplies two `normal(shape, device)` draws.
    The gradient is taken with respect to the latent alone: no parameter's
    `.grad` is touched."""
    with torch.no_grad():
        out_b = model.forward_single_quality(x_padded, 0.0, "point-based-std", training=False)
        out_e = model.forward_single_quality(x_padded, q_eps, "point-based-std", training=False)
        mu_b, mu_e = out_b["mu"], out_e["mu"]
        std_b = snap_to_scale_table(out_b["std"], scale_table)
        std_e = snap_to_scale_table(out_e["std"], scale_table)
        y_b = mu_b + std_b * noise.normal(mu_b.shape, mu_b.device)
        y_e = (mu_e + std_e * noise.normal(mu_e.shape, mu_e.device)) + y_b
        diff = torch.abs(y_b - y_e)
        synth = model._synth_net(1)
        target = nhwc(synth(nchw(y_e)))
    with torch.enable_grad():
        latent = y_b.detach().requires_grad_()
        loss = (255.0**2) * torch.mean((nhwc(synth(nchw(latent))) - target) ** 2)
        (grad,) = torch.autograd.grad(loss, latent)
    return torch.abs(grad) * diff


class MaskEstractor(nn.Module):
    """Predicts the importance map from the base latent, the
    minimal-enhancement latent and the (mu | std) entropy parameters of
    both: two ResidualBlocks per input, concatenated, then a (2n, n) head,
    with an optional sigmoid.  Flax infers the input widths; the port takes
    them up front (`training/mask_trainer.py:mask_feature_widths`).  The
    children carry JAX's names.  Inputs and output are channel-last."""

    def __init__(self, n: int, cin_y_base: int, cin_y_p0: int, cin_params_base: int,
                 cin_params_p0: int, normalize: bool = False, device=None):
        super().__init__()
        self.normalize = normalize
        for label, cin in (("base_rep", cin_y_base), ("p0_rep", cin_y_p0),
                           ("base_ent", cin_params_base), ("p0_ent", cin_params_p0)):
            setattr(self, f"{label}0", ResidualBlock(cin, n, device=device))
            setattr(self, f"{label}1", ResidualBlock(n, n, device=device))
        self.enc0 = ResidualBlock(4 * n, 2 * n, device=device)
        self.enc1 = ResidualBlock(2 * n, n, device=device)

    def forward(self, y_base, y_p0, params_base, params_p0):
        feats = [getattr(self, f"{label}1")(getattr(self, f"{label}0")(nchw(v)))
                 for label, v in (("base_rep", y_base), ("p0_rep", y_p0),
                                  ("base_ent", params_base), ("p0_ent", params_p0))]
        ret = self.enc1(self.enc0(torch.cat(feats, dim=1)))
        if self.normalize:
            ret = torch.sigmoid(ret)
        return nhwc(ret)
