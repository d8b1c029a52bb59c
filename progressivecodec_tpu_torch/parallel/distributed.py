"""Multi-process start-up, the collectives of `parallel/`, and cross-process
metric reductions.

Counterpart of `progressivecodec_tpu/parallel/distributed.py`.  JAX starts
a pod run with `jax.distributed.initialize`; the port starts one process
per rank with the same three environment variables and joins them in a
`torch.distributed` process group:

  COORDINATOR_ADDRESS  host:port of rank 0's store (tcp://)
  PROCESS_COUNT        the number of ranks
  PROCESS_ID           this rank

Backends: "nccl" when every rank has a card of its own (rank r drives
cuda:(r % device_count)); "gloo" when ranks share a card, or on the CPU,
and then the caller names it.  More NCCL ranks on a host than cards raises:
there is no silent switch between the two.

Every collective of `parallel/` goes through `all_gather`, `all_reduce` or
`exchange` here.  They put a tensor where the group's backend takes it:
NCCL on the card; gloo in host memory, with an explicit copy to the host
and back for a CUDA tensor (gloo has no send/recv or all_gather on CUDA
tensors).  The compute stays on the caller's device.  Each route is logged
once per process.  No collective failure is caught.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_WIRE_TYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.uint8,
               torch.int8, torch.int32, torch.int64)
_ROUTES_LOGGED: set = set()


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1) when no
    group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_process_group(init_method: str, world: int, rank: int, backend: str | None = None,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> tuple[int, int]:
    """Join rank `rank` of `world` at `init_method` (tcp://host:port or
    file:///path).  backend None means "nccl", which needs a card per rank
    on the host (`LOCAL_WORLD_SIZE` ranks per host, default all of them);
    name "gloo" for ranks that share a card or run on the CPU.  With CUDA
    present the rank's device becomes cuda:(rank % device_count).
    Returns (rank, world)."""
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs on 'nccl' or 'gloo'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local > cards:
            raise ValueError(
                f"nccl needs a card per rank: {local} ranks on this host, {cards} cards; "
                "name backend='gloo' for ranks that share a card or run on the CPU"
            )
    if cards:
        torch.cuda.set_device(rank % cards)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    return rank, world


def initialize_from_env(backend: str | None = None,
                        timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> tuple[int, int]:
    """Join the process group that COORDINATOR_ADDRESS / PROCESS_COUNT /
    PROCESS_ID describe; without COORDINATOR_ADDRESS do nothing.  Returns
    (rank, world), (0, 1) for one process."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return process_index_count()
    return init_process_group(f"tcp://{addr}", int(os.environ["PROCESS_COUNT"]),
                              int(os.environ["PROCESS_ID"]), backend, timeout)


def _carrier(t: torch.Tensor, group) -> torch.device:
    """The device on which `group`'s backend takes `t`."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        dev = torch.device("cpu")
    elif backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"an nccl collective needs CUDA tensors, got one on {t.device}")
        dev = t.device
    else:
        raise ValueError(f"backend {backend!r}: the port runs on 'nccl' or 'gloo'")
    route = (backend, t.device.type)
    if route not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add(route)
        how = "through host memory" if dev.type != t.device.type else f"on {dev.type}"
        log.info("collectives: %s tensors on %s go %s", t.device.type, backend, how)
    return dev


def _carried(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of `t` on `dev` that a collective may overwrite."""
    return t.detach().to(dev, copy=True).contiguous()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as a type both backends move: int16 stream words (neither gloo
    nor NCCL has the type) travel as their bytes."""
    return t if t.dtype in _WIRE_TYPES else t.reshape(-1).view(torch.uint8)


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(like.device) if like.dtype in _WIRE_TYPES else (
        w.view(like.dtype).reshape(like.shape).to(like.device))


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's `t` (same shape and type on every rank), in group-rank
    order, on `t`'s device."""
    src = _wire(_carried(t, _carrier(t, group)))
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return [_unwire(o, t) for o in outs]


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in group-rank order."""
    return torch.cat(all_gather(t, group), dim=dim)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's `t`, as a new tensor on `t`'s device."""
    buf = _carried(t, _carrier(t, group))
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def exchange(sends: dict, recvs: dict, group=None) -> dict:
    """Point-to-point within `group`: `sends` {group rank: tensor} goes out,
    `recvs` {group rank: like-tensor} says what comes in from whom (shape
    and type).  Returns {group rank: received tensor} on the like-tensors'
    devices.  All transfers are posted at once (`batch_isend_irecv`)."""
    ops, landed = [], {}
    for peer, t in sends.items():
        ops.append(dist.P2POp(dist.isend, _wire(_carried(t, _carrier(t, group))),
                              dist.get_global_rank(group, peer), group))
    for peer, like in recvs.items():
        buf = _wire(torch.empty(like.shape, dtype=like.dtype, device=_carrier(like, group)))
        landed[peer] = (buf, like)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {peer: _unwire(buf, like) for peer, (buf, like) in landed.items()}


def allreduce_metrics(metrics: dict) -> dict:
    """Per-key mean over the processes of the default group; the metrics
    as they are for one process.  A tensor value comes back as a tensor of
    its shape, type and device, a number as a float."""
    _, world = process_index_count()
    if world == 1:
        return metrics
    vals = [torch.as_tensor(v, dtype=torch.float64).detach().cpu() for v in metrics.values()]
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    flat = all_reduce(torch.cat([a.reshape(-1) for a in vals]).to(dev)).cpu() / world
    out, at = {}, 0
    for (k, v), a in zip(metrics.items(), vals):
        mean = flat[at : at + a.numel()].reshape(a.shape)
        at += a.numel()
        out[k] = mean.to(v.device, v.dtype) if isinstance(v, torch.Tensor) else float(mean)
    return out
