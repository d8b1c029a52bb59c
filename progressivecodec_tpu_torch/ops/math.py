"""Core autograd ops: straight-through rounding, bounded max, reparam.

Counterpart of `progressivecodec_tpu/ops/math.py`:
  * ste_round: `round(x)` forward, identity gradient;
  * lower_bound: `max(x, bound)` forward; the gradient passes where
    `x >= bound` or where it pushes x upward (g < 0);
  * nonneg_reparam: `lower_bound(x, b)^2 - pedestal`, pedestal = (2^-18)^2,
    b = sqrt(minimum + pedestal).
"""

from __future__ import annotations

import torch

REPARAM_OFFSET = 2.0**-18
PEDESTAL = REPARAM_OFFSET**2


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


class _LowerBound(torch.autograd.Function):
    # the bound stays a Python number: torch rounds it to x's dtype and passes
    # it to the kernel as an argument, so no copy to the card and no wait
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def nonneg_reparam(x: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Map an unconstrained parameter to a non-negative value (>= minimum)."""
    bound = (minimum + PEDESTAL) ** 0.5
    out = lower_bound(x, bound)
    return out * out - PEDESTAL


def nonneg_init(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`nonneg_reparam` for parameter initialization."""
    return torch.sqrt(torch.clamp_min(x + PEDESTAL, PEDESTAL))
