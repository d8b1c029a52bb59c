"""The train step over a (data, model) mesh.

Counterpart of `progressivecodec_tpu/parallel/sharding.py`, where the
sharded step is sharding annotations on the unsharded `make_train_step`.
The port's step computes the same numbers as `training/step.make_train_step`
on the whole global batch, by hand:

  data   each rank takes its rows of the global batch and its part of the
         global batch's noise (`ops/noise.RankSliceNoise`); after the
         backward the gradients are averaged over the axis, before both
         optimisers;
  model  the parameters that `shard_params_rule` shards are stored as
         shards: rank j of the axis holds the j-th of m equal slices along
         the parameter's JAX output dim, and the Adam moments exist for
         that slice only.  The step all_gathers the full tensors before the
         forward, keeps the rank's slice of each gradient, and frees the
         full tensors again.  The ranks of a "model" row compute on the
         same rows, so their gradients agree and nothing is reduced over
         "model" but the clip's squared norm.

The clip takes optax's global norm over full tensors: the squared norms of
the shards are summed over "model" and added to the replicated leaves'.
A parameter that the quality ladder leaves without a gradient gets no
reduction and no update, as in the unsharded step (Adam skips it); the
graph is the same on every rank, so every rank skips the same leaves.
All collectives go through `parallel/distributed.py`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn as nn
from torch.distributed.tensor import Shard

from progressivecodec_tpu_torch.ops.noise import RankSliceNoise
from progressivecodec_tpu_torch.parallel.distributed import all_gather, all_reduce
from progressivecodec_tpu_torch.parallel.mesh import batch_sharding, shard_params_rule
from progressivecodec_tpu_torch.training.optim import Optimizers, clip_by_global_norm_
from progressivecodec_tpu_torch.training.step import TrainState, train_loss


class ParamShard(NamedTuple):
    name: str
    param: nn.Parameter  # the module's parameter: empty between steps
    storage: nn.Parameter  # this rank's slice, which the optimiser updates
    dim: int


class ShardedOptimizers(Optimizers):
    """`Optimizers` over shards and replicated leaves, whose clip takes the
    norm over full tensors."""

    def __init__(self, model, lr, aux_lr, clip_max_norm, params, shards, model_group):
        super().__init__(model, lr, aux_lr, clip_max_norm, params=params)
        self._sharded = {id(s.storage) for s in shards}
        self._group = model_group

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor | None:
        """The norm of the main gradients over full tensors (None without
        any): the shards' squared norms summed over "model", plus the
        replicated leaves'."""
        sq = {True: [], False: []}
        for p in self.main_params:
            if p.grad is not None:
                sq[id(p) in self._sharded].append(p.grad)
        total = None
        for sharded, grads in sq.items():
            if grads:
                part = torch.stack(torch._foreach_norm(grads)).square().sum()
                part = all_reduce(part, self._group) if sharded else part
                total = part if total is None else total + part
        return None if total is None else total.sqrt()

    def step(self) -> None:
        clip_by_global_norm_(self.main_params, self.clip_max_norm, self.global_norm())
        self.main.step()
        self.aux.step()


@dataclasses.dataclass
class ShardedTrainState:
    model: nn.Module
    opt: ShardedOptimizers
    mesh: object
    shards: list
    step: int = 0


def _free(p: nn.Parameter) -> None:
    p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def shard_train_state(state: TrainState, mesh) -> ShardedTrainState:
    """Store the parameters that `shard_params_rule(mesh)` shards, and their
    Adam moments, as this rank's slices over "model"; the rest stays whole.
    The model's sharded parameters are empty between steps (`gather_full`
    gives the full tensors)."""
    rule = shard_params_rule(mesh)
    m, j = mesh["model"].size(), mesh.get_local_rank("model")
    shards, named, by_param = [], [], {}
    for mod_name, mod in state.model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            place = rule(mod, pname, p)
            if isinstance(place, Shard):
                storage = nn.Parameter(p.detach().chunk(m, place.dim)[j].clone(),
                                       requires_grad=p.requires_grad)
                shards.append(ParamShard(name, p, storage, place.dim))
                by_param[p] = (storage, place.dim)
                named.append((name, storage))
            else:
                named.append((name, p))
    old = state.opt
    opt = ShardedOptimizers(state.model, old.lr, old.aux.param_groups[0]["lr"],
                            old.clip_max_norm, named, shards, mesh.get_group("model"))
    for src, dst in ((old.main, opt.main), (old.aux, opt.aux)):
        for p, st in src.state.items():
            storage, d = by_param.get(p, (p, None))
            dst.state[storage] = {
                k: v.chunk(m, d)[j].clone() if d is not None and v.shape == p.shape else v
                for k, v in st.items()
            }
    for s in shards:
        _free(s.param)
    return ShardedTrainState(state.model, opt, mesh, shards, state.step)


def _gather_params(state: ShardedTrainState) -> None:
    """Every sharded parameter's full tensor into its module (one gather)."""
    if not state.shards:
        return
    flat = torch.cat([s.storage.detach().reshape(-1) for s in state.shards])
    rows = all_gather(flat, state.mesh.get_group("model"))
    at = 0
    for s in state.shards:
        n = s.storage.numel()
        s.param.data = torch.cat([r[at : at + n].view(s.storage.shape) for r in rows], dim=s.dim)
        at += n


def _mean_grads_over_data(state: ShardedTrainState) -> None:
    """Average every present gradient over "data" (one all_reduce)."""
    n = state.mesh["data"].size()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), state.mesh.get_group("data")) / n
    at = 0
    for g in grads:
        g.copy_(flat[at : at + g.numel()].view_as(g))
        at += g.numel()


def _keep_slices(state: ShardedTrainState) -> None:
    """Each sharded gradient's slice into its storage; free the full tensors."""
    m, j = state.mesh["model"].size(), state.mesh.get_local_rank("model")
    for s in state.shards:
        if s.param.grad is not None:
            s.storage.grad = s.param.grad.chunk(m, s.dim)[j].clone()
        s.param.grad = None
        _free(s.param)


def make_sharded_train_step(mesh, quality=(0, 10), mask_pol: str | None = None):
    """-> step(state, global_batch, noise) -> (state, metrics): the step of
    `training/step.make_train_step` on the global batch (B rows, a multiple
    of the "data" size), with `noise` the global batch's noise source,
    the same on every rank.  The metrics are means over "data", detached,
    on every rank."""

    def step(state: ShardedTrainState, global_batch: torch.Tensor, noise):
        n, i = mesh["data"].size(), mesh.get_local_rank("data")
        _gather_params(state)
        state.opt.zero_grad()
        total, metrics = train_loss(state.model, batch_sharding(mesh, global_batch), quality,
                                    mask_pol, RankSliceNoise(noise, i, n))
        total.backward()
        _mean_grads_over_data(state)
        _keep_slices(state)
        state.opt.step()
        state.step += 1
        metrics["loss_total"] = total
        keys = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                            device=total.device).detach() for k in keys])
        if n > 1:
            vals = all_reduce(vals, mesh.get_group("data")) / n
        return state, dict(zip(keys, vals.unbind()))

    return step


def gather_full(state: ShardedTrainState, grads: bool = False) -> dict:
    """{name: the full parameter} (or its gradient, where it has one) on
    every rank, from the shards and the replicated leaves."""
    sharded = {s.name: s for s in state.shards}
    out = {}
    for name, p in state.model.named_parameters():
        s = sharded.get(name)
        if s is None:
            t = p.grad if grads else p
        else:
            t = s.storage.grad if grads else s.storage
            if t is not None:
                t = torch.cat(all_gather(t.detach(), state.mesh.get_group("model")), dim=s.dim)
        if t is not None:
            out[name] = t.detach()
    return out


def resident_param_bytes(state: ShardedTrainState) -> int:
    """Bytes of parameters this rank holds between steps: the shards and
    the replicated leaves."""
    held = list(state.model.parameters()) + [s.storage for s in state.shards]
    return sum(p.numel() * p.element_size() for p in held)
