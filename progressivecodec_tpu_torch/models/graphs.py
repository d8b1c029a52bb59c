"""CUDA graphs of the unrolled enhancement's quality-independent networks.

`GranularCodec._prog_loop` codes the unrolled enhancement slice by slice.
Per slice and per side of a round trip it runs three networks whose work
does not depend on the quality's value, each a *unit* here:
  * `("params", i)`: the slice's parameter networks (`_prog_slice_nhwc`:
    the supports, `cc_mean_transforms_prog[i]`, `cc_scale_transforms_prog[i]`);
  * `("bank", k, i)`: a refinement bank (REM's `post_latent[k][i]`, one unit
    per checkpoint interval k: the quality picks which one runs);
  * `("recon", i)`: the reconstruction tail (`_prog_recon`: dequantise, LRP,
    tanh, merge).
At batch 1 on 32x48 maps their ~140 launches per slice cost the host more
than the card spends running them.  A `ShapeGraphs` captures every unit of
one latent shape as a CUDA graph and replays it; what depends on the
quality or on the stream (the mask ranks, the keep decision, the CDF
indexes, the coder) stays eager between the replays, so the quality never
becomes a captured constant.

A model fragment calls `units().run(key, fn, *args)` where it would call
`fn(*args)`; `key` names the unit and fixes its non-tensor arguments.
`units()` is the loop's set while `active(set)` is open (the codec opens it
around `_prog_loop`), else `EAGER`, which calls fn: the training forward,
`forward_single_quality` and a fragment called on its own stay eager.
`prepare(make)` captures, on a shape's capture pass, the units `make()`
lists without running them: the banks of every checkpoint interval,
whichever the capturing quality picks.

Inputs and outputs.  A replay copies each tensor argument into the graph's
own input buffer, unless the argument is the buffer the graph reads in
place: the loop's request-constant inputs are staged into buffers of the
shape once per loop (`stage`, `anchors`), and an earlier unit's outputs are
read where that unit wrote them.  An argument that is not the buffer a
graph reads in place (a bank's output, say, where another interval's was
captured) makes that unit run eagerly.  A unit's outputs are the graph's
buffers and are overwritten by its next replay; the loop returns a fresh
`torch.cat` of them, so none escapes it.

Engagement (`LoopGraphs.units`): a capture backend that supports the
latents' device (`CudaGraphs`: a CUDA device), grad disabled and the model
in eval.  The first loop at a latent shape runs eagerly, the second
captures every unit of the shape and replays them, every later one
replays.  The graphs of `MAX_SHAPES` shapes are kept, the least recently
used dropped first; `clear()` drops them all (the codec does when the
model's weights are replaced).

A replay runs the kernels the capture recorded, which are the eager path's
(the same cuDNN heuristics under `device.set_deterministic`), in the same
order, on the same inputs: the same bits.

Counters (`utils/profiling.count`): `graph:capture` per graph captured,
`graph:replay` per unit replayed and `graph:eager` per unit a codec loop
ran eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from progressivecodec_tpu_torch.utils.profiling import count

MAX_SHAPES = 4


def _leaves(args, out: list) -> list:
    """The tensors of nested tuples and lists, in order."""
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            _leaves(a, out)
    return out


def _rebuild(args, tensors):
    """`args` with its tensors replaced, in order, by those of the iterator."""
    return tuple(
        next(tensors) if isinstance(a, torch.Tensor)
        else type(a)(_rebuild(a, tensors)) if isinstance(a, (tuple, list)) else a
        for a in args
    )


class Eager:
    """Every unit a plain call."""

    def run(self, key, fn, *args):
        return fn(*args)

    def prepare(self, make) -> None:
        pass

    def stage(self, name: str, tensors) -> list:
        return list(tensors)

    def anchors(self, model, n: int, y_hat_base, checkpoint_rep) -> list:
        """The refinement anchors of enhancement slices 0..n-1: None for a
        slice's base slice, else its channels of `checkpoint_rep`."""
        if checkpoint_rep is None:
            return [None] * n
        return [model._hook_anchor(i, y_hat_base, checkpoint_rep) for i in range(n)]


class CountedEager(Eager):
    """A codec loop whose units run eagerly, each counted as `graph:eager`."""

    def run(self, key, fn, *args):
        count("graph:eager")
        return fn(*args)


EAGER = Eager()
COUNTED_EAGER = CountedEager()


class _Active(threading.local):
    units = EAGER


_active = _Active()


def units() -> Eager:
    """The units of the codec loop running on this thread, else `EAGER`."""
    return _active.units


@contextlib.contextmanager
def active(u: Eager):
    """Fragments called inside the block run their units through `u`."""
    prev, _active.units = _active.units, u
    try:
        yield u
    finally:
        _active.units = prev


class CudaGraphs:
    """The capture backend: a `torch.cuda.CUDAGraph` per unit, captured on a
    side stream after one eager warm-up run there (library handles and
    workspaces are set up outside the capture), in the shape's memory pool."""

    def __init__(self):
        self._streams: dict = {}

    def supports(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def capture(self, fn, args, pool):
        """-> (replay, the outputs of fn on args, which each replay rewrites)."""
        dev = _leaves(args, [])[0].device
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        here = torch.cuda.current_stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            fn(*args)
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool)
            try:
                out = fn(*args)
            finally:
                g.capture_end()
        here.wait_stream(side)
        return g.replay, out


class _Unit:
    __slots__ = ("replay", "inputs", "private", "outputs")

    def __init__(self, replay, inputs, private, outputs):
        self.replay, self.inputs, self.private, self.outputs = replay, inputs, private, outputs

    def load(self, args) -> bool:
        """Copy the arguments into the graph's own input buffers; False when
        an argument is not the buffer the graph reads in place."""
        for a, s, own in zip(_leaves(args, []), self.inputs, self.private):
            if a is s:
                continue
            if a.shape != s.shape:
                return False
            if own:
                s.copy_(a)
            elif a.data_ptr() != s.data_ptr() or a.stride() != s.stride():
                return False
        return True


class ShapeGraphs(Eager):
    """The graphs of one latent shape, with its staged inputs."""

    def __init__(self, backend):
        self.backend = backend
        self.pool = backend.pool()
        self.capturing = True
        self._units: dict = {}
        self._staged: dict = {}
        self._held: set = set()  # storages the graphs read in place

    def _hold(self, t: torch.Tensor) -> None:
        self._held.add(t.untyped_storage().data_ptr())

    def stage(self, name: str, tensors) -> list:
        """Request-constant tensors of one shape copied into this shape's
        buffer `name` (one launch); returns views of it, the same objects on
        every call."""
        got = self._staged.get(name)
        if got is None:
            buf = torch.stack(list(tensors))
            got = self._staged[name] = (buf, list(buf.unbind(0)))
            self._hold(buf)
        else:
            torch.stack(list(tensors), out=got[0])
        return got[1]

    def anchors(self, model, n: int, y_hat_base, checkpoint_rep) -> list:
        """Every slice's anchor staged, a base slice included, so one bank
        graph serves loops with and without a checkpoint."""
        return self.stage("anchor", [model._hook_anchor(i, y_hat_base, checkpoint_rep)
                                     for i in range(n)])

    def _capture(self, key, fn, args) -> _Unit:
        leaves = _leaves(args, [])
        private = [a.untyped_storage().data_ptr() not in self._held for a in leaves]
        inputs = [a.clone() if own else a for a, own in zip(leaves, private)]
        replay, out = self.backend.capture(fn, _rebuild(args, iter(inputs)), self.pool)
        for t in _leaves((out,), []):
            self._hold(t)
        u = self._units[key] = _Unit(replay, inputs, private, out)
        count("graph:capture")
        return u

    def prepare(self, make) -> None:
        if self.capturing:
            for key, fn, args in make():
                if key not in self._units:
                    self._capture(key, fn, args)

    def run(self, key, fn, *args):
        u = self._units.get(key)
        if u is None and self.capturing:
            u = self._capture(key, fn, args)
        if u is None or not u.load(args):
            count("graph:eager")
            return fn(*args)
        u.replay()
        count("graph:replay")
        return u.outputs


class LoopGraphs:
    """A codec's graph sets, one per latent shape (the module's docstring)."""

    def __init__(self):
        self.backend = CudaGraphs()  # a test may set another
        self.max_shapes = MAX_SHAPES
        self._shapes: collections.OrderedDict = collections.OrderedDict()  # None: seen once

    def clear(self) -> None:
        self._shapes.clear()

    def shapes(self) -> dict:
        """{shape key: whether its graphs exist}, least recently used first."""
        return {k: v is not None for k, v in self._shapes.items()}

    def units(self, model, lm: torch.Tensor) -> Eager:
        """The units of one loop over the latent means lm (B, h, w, C)."""
        if model.training or torch.is_grad_enabled() or not self.backend.supports(lm.device):
            return COUNTED_EAGER
        key = (tuple(lm.shape), lm.dtype, lm.device)
        if key not in self._shapes:
            self._shapes[key] = None
            while len(self._shapes) > self.max_shapes:
                self._shapes.popitem(last=False)
            return COUNTED_EAGER
        self._shapes.move_to_end(key)
        s = self._shapes[key]
        if s is None:
            s = self._shapes[key] = ShapeGraphs(self.backend)
        else:
            s.capturing = False
        return s
