"""The device mesh and the parameter sharding rule.

Counterpart of `progressivecodec_tpu/parallel/mesh.py`.  The mesh is a
`torch.distributed` DeviceMesh over every rank, with JAX's axes:

  data   the batch: each rank of a "data" row takes its rows of the global
         batch, and gradients are averaged over the axis;
  model  the wide output-channel dims of the parameters: the leaves that
         `shard_params_rule` picks are stored as 1/m shards over the axis
         (parallel/sharding.py), and the coder's lane groups
         (parallel/sharded_coder.py) and the width tiles
         (parallel/tiling.py) run one per rank along it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """An (n_data, n_model) DeviceMesh named ("data", "model") over every
    rank of the default process group; n_data defaults to world // n_model.
    `device_type` is the ranks' own ("cuda", or "cpu" when asked)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {world} ranks")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def check_axis(mesh, axis: str) -> None:
    """Raise TypeError unless `mesh` is a DeviceMesh, ValueError unless it
    names `axis`."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"want a torch DeviceMesh, got {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {axis!r}")


def jax_out_dim(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The dim of port parameter `module.<name>` that holds the last axis
    of its JAX leaf (`models/weights.py:from_jax_params`): a conv's HWIO
    kernel becomes OIHW (dim 0), a deconv's becomes IOHW (dim 1), a Dense
    (in, out) kernel becomes (out, in) (dim 0), biases keep theirs (dim 0);
    every other leaf (GDN, attention tables, the bottleneck) is copied, so
    its last dim."""
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return 1
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return 0
    return p.dim() - 1


def shard_params_rule(mesh: DeviceMesh, min_dim: int = 64):
    """-> rule(module, name, param) -> Shard(dim) or Replicate(), the
    placement of `module.<name>` on the "model" axis.  A parameter is
    sharded exactly where JAX's rule shards its leaf: the leaf's last dim
    (the torch dim `jax_out_dim` names) is at least `min_dim` and a
    multiple of the axis size m > 1."""
    m = mesh.size(AXES.index("model"))

    def rule(module: nn.Module, name: str, p: torch.Tensor):
        if m > 1 and p.dim() >= 1:
            d = jax_out_dim(module, name, p)
            if p.shape[d] >= min_dim and p.shape[d] % m == 0:
                return Shard(d)
        return Replicate()

    return rule


def batch_sharding(mesh: DeviceMesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch along "data"."""
    n = mesh.size(AXES.index("data"))
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} is not a multiple of the {n} data ranks")
    b = batch.shape[0] // n
    return batch.narrow(0, mesh.get_local_rank("data") * b, b)


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of `x`: every rank holds all of it."""
    return x
