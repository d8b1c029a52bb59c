"""Optimisers: the main Adam over every parameter but the bottleneck's
quantiles, a separate aux Adam over the quantiles, and the plateau lr
schedule.

Counterpart of `progressivecodec_tpu/training/optim.py`.  JAX builds one
optax `multi_transform`; the port holds two `torch.optim.Adam`s:
  main: clip by the global norm of the main gradients (optax's formula:
        g * max_norm / norm where norm >= max_norm, with no epsilon, unlike
        `torch.nn.utils.clip_grad_norm_`), Adam(lr), times the plateau
        scale, which `set_lr_scale` writes into the lr;
  aux:  Adam(aux_lr), unclipped.
Frozen parameters (`requires_grad=False`, training/freeze.py) are in
neither optimiser and out of the clip norm, as `optax.masked` keeps them
out of JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AUX_PARAM = "entropy_bottleneck.quantiles"


def param_labels(model: torch.nn.Module) -> dict:
    """{parameter name: "aux" for the bottleneck's quantiles, else "main"}."""
    return {name: "aux" if name == AUX_PARAM else "main" for name, _ in model.named_parameters()}


class Optimizers:
    """The main and the aux Adam of one model, with the main group's clip
    and base lr."""

    def __init__(self, model: torch.nn.Module, lr: float = 1e-4, aux_lr: float = 1e-3,
                 clip_max_norm: float = 1.0, params=None):
        """params: the (name, tensor) pairs to optimise in place of the
        model's own parameters (parallel/sharding.py passes its shards)."""
        labels = param_labels(model)
        named = model.named_parameters() if params is None else params
        trainable = [(n, p) for n, p in named if p.requires_grad]
        self.main_params = [p for n, p in trainable if labels[n] == "main"]
        self.aux_params = [p for n, p in trainable if labels[n] == "aux"]
        self.lr = lr
        self.clip_max_norm = clip_max_norm
        # one group each, which may be empty when a freeze leaves nothing to learn
        self.main = torch.optim.Adam([{"params": self.main_params}], lr=lr)
        self.aux = torch.optim.Adam([{"params": self.aux_params}], lr=aux_lr)

    def zero_grad(self) -> None:
        self.main.zero_grad(set_to_none=True)
        self.aux.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip the main gradients, then step both optimisers."""
        clip_by_global_norm_(self.main_params, self.clip_max_norm)
        self.main.step()
        self.aux.step()

    def state_dict(self) -> dict:
        return {"main": self.main.state_dict(), "aux": self.aux.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.main.load_state_dict(state["main"])
        self.aux.load_state_dict(state["aux"])


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm of the
    gradients is at least max_norm, each gradient g becomes
    g / norm * max_norm.  Returns the norm, on the gradients' device.
    `norm` is the global norm when the caller takes it (over full tensors,
    where the gradients are shards: parallel/sharding.py).  Two
    multi-tensor launches; where the norm is kept they divide and multiply
    by 1, which leaves g's bits as they are."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm is None:
        norm = torch.nn.utils.get_total_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def set_lr_scale(opt: Optimizers, scale: float) -> None:
    """Write lr * scale (the plateau scale) into the main optimiser."""
    for group in opt.main.param_groups:
        group["lr"] = opt.lr * scale


class PlateauState(NamedTuple):
    """Host-side ReduceLROnPlateau: scale *= factor after `patience`
    epochs without improvement."""

    best: float
    bad_epochs: int
    scale: float


def plateau_init() -> PlateauState:
    return PlateauState(best=float("inf"), bad_epochs=0, scale=1.0)


def plateau_update(state: PlateauState, metric: float, factor: float = 0.3,
                   patience: int = 8) -> PlateauState:
    if metric < state.best - 1e-8:
        return PlateauState(best=metric, bad_epochs=0, scale=state.scale)
    bad = state.bad_epochs + 1
    if bad > patience:
        return PlateauState(best=state.best, bad_epochs=0, scale=state.scale * factor)
    return PlateauState(best=state.best, bad_epochs=bad, scale=state.scale)
