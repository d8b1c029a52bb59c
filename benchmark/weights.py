"""Seeded weights, drawn on the device under the model's state-dict names.

A configuration draws its weights from its own `weights_seed`: the model is
fixed, as a deployment's checkpoint is, and the run's seed draws the traffic.

The shapes and the kind of each tensor come from the configuration's plain
reference's `param_spec`; the draw follows the initialisers of the
program's JAX original (Kaiming-normal fan_out convolutions and
deconvolutions with zero biases, lecun-normal truncated attention
projections, truncated-normal relative-position tables, GDN at beta = 1 and
gamma = 0.1 I in its reparametrised space, the entropy bottleneck's own
start, LayerNorm gains at one), with REM's `zero_out` projections drawn
from N(0, 0.02^2) so that every bank changes sigma.  A reference may
declare kinds of its own (`INIT_KINDS`, `benchmark/reference/__init__.py`).
A configuration file's "init" object overrides the std (or sets a
constant) of the tensors whose names match a regular expression.

Each kind is drawn in one call on a `torch.Generator` of the device, so the
set-up launches a handful of kernels, not one per tensor.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from benchmark.reference.model import EB_FILTERS, PEDESTAL, fan_std

F32 = torch.float32
ZERO_OUT_STD = 0.02
RELPOS_STD = 0.02
EB_INIT_SCALE = 10.0


def _nonneg_init(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x + PEDESTAL, PEDESTAL))


def _split(flat: torch.Tensor, shapes) -> list:
    out, off = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[off : off + n].view(s))
        off += n
    return out


def draw_weights(spec, seed: int, device, init: dict | None = None, kinds: dict | None = None) -> dict:
    """{name: tensor} for `spec` ([(name, shape, kind)]) from `seed`; `kinds`
    ({kind: {"std": s} | {"const": c}}) draws kinds of the reference's own."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    rules = [(re.compile(k), v) for k, v in (init or {}).items()]

    def override(name):
        for pat, rule in rules:
            if pat.fullmatch(name):
                return rule
        return None

    groups: dict = {"normal": [], "trunc": [], "uniform": [], "const": []}
    for name, shape, kind in spec:
        rule = override(name)
        if rule is not None and "const" in rule:
            groups["const"].append((name, shape, float(rule["const"])))
        elif kind in (kinds or {}):
            own = rule or kinds[kind]
            if "const" in own:
                groups["const"].append((name, shape, float(own["const"])))
            else:
                groups["normal"].append((name, shape, float(own["std"])))
        elif kind in ("conv", "deconv", "zero_out"):
            std = ZERO_OUT_STD if kind == "zero_out" else fan_std(shape, kind)
            groups["normal"].append((name, shape, rule["std"] if rule else std))
        elif kind in ("linear", "relpos"):
            std = RELPOS_STD if kind == "relpos" else fan_std(shape, kind)
            groups["trunc"].append((name, shape, rule["std"] if rule else std))
        elif kind == "eb_bias":
            groups["uniform"].append((name, shape, None))
        elif kind in ("bias", "zero_out_bias", "eb_factor"):
            groups["const"].append((name, shape, 0.0))
        elif kind == "ones":
            groups["const"].append((name, shape, 1.0))
        elif kind == "gdn_beta":
            groups["const"].append((name, shape, float(_nonneg_init(torch.ones(())))))
        elif kind == "eb_matrix":
            i = int(name[-1])
            scale = EB_INIT_SCALE ** (1 / (len(EB_FILTERS) - 1))
            groups["const"].append((name, shape, float(np.log(np.expm1(1 / scale / EB_FILTERS[i + 1])))))
        elif kind not in ("gdn_gamma", "eb_quantiles"):
            raise ValueError(f"no initialiser for {name} ({kind})")

    out: dict = {}

    def fill(items, draw):
        if not items:
            return
        shapes = [s for _, s, _ in items]
        total = sum(math.prod(s) for s in shapes)
        flat = draw(total)
        if items[0][2] is not None:
            stds = torch.tensor([v for _, _, v in items], dtype=F32, device=device)
            counts = torch.tensor([math.prod(s) for s in shapes], device=device)
            flat = flat * torch.repeat_interleave(stds, counts)
        for (name, _, _), t in zip(items, _split(flat, shapes)):
            out[name] = t

    fill(groups["normal"], lambda n: torch.randn(n, generator=gen, device=device, dtype=F32))
    fill(groups["trunc"], lambda n: torch.nn.init.trunc_normal_(
        torch.empty(n, device=device, dtype=F32), 0.0, 1.0, -2.0, 2.0, generator=gen))
    fill(groups["uniform"], lambda n: torch.rand(n, generator=gen, device=device, dtype=F32) - 0.5)
    fill(groups["const"], lambda n: torch.ones(n, device=device, dtype=F32))
    for name, shape, kind in spec:
        if kind == "gdn_gamma":
            out[name] = _nonneg_init(0.1 * torch.eye(shape[0], device=device, dtype=F32))
        elif kind == "eb_quantiles":
            q = torch.tensor([-EB_INIT_SCALE, 0.0, EB_INIT_SCALE], device=device, dtype=F32)
            out[name] = q.reshape(1, 1, 3).expand(shape).contiguous()
    return {name: out[name] for name, _, _ in spec}


def config_weights(ref, conf: dict, device) -> dict:
    """The weights of a configuration file `conf`, drawn from its
    `weights_seed` by the spec and kinds of its reference module `ref`."""
    return draw_weights(ref.param_spec(ref.Cfg(conf["model"])), conf["weights_seed"], device,
                        conf.get("init"), getattr(ref, "INIT_KINDS", None))
