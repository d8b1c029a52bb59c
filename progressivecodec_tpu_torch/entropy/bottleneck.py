"""Factorized-prior entropy bottleneck for the z latent: parameters, medians,
the likelihood forward (noise-quantised in training, rounded at eval),
`aux_loss` and the host-side CDF table builder.

Counterpart of `progressivecodec_tpu/entropy/bottleneck.py`.  Parameter
names follow the reference (`_matrix{i}`, `_bias{i}`, `_factor{i}`,
`quantiles`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.entropy.cdf import batched_pmf_to_cdf
from progressivecodec_tpu_torch.ops.math import lower_bound

_FILTERS = (3, 3, 3, 3)
F32 = torch.float32
LIKELIHOOD_BOUND = 1e-9


class EntropyBottleneck(nn.Module):
    """Learned univariate density per channel (5-stage monotone MLP CDF)."""

    def __init__(self, channels: int, tail_mass: float = 1e-9, init_scale: float = 10.0,
                 device=None):
        super().__init__()
        self.channels = channels
        self.tail_mass = tail_mass
        self.init_scale = init_scale
        filters = (1,) + _FILTERS + (1,)
        c = channels
        for i in range(len(_FILTERS) + 1):
            self.register_parameter(
                f"_matrix{i}",
                nn.Parameter(torch.zeros(c, filters[i + 1], filters[i], device=device, dtype=F32)),
            )
            self.register_parameter(
                f"_bias{i}",
                nn.Parameter(torch.zeros(c, filters[i + 1], 1, device=device, dtype=F32)),
            )
            if i < len(_FILTERS):
                self.register_parameter(
                    f"_factor{i}",
                    nn.Parameter(torch.zeros(c, filters[i + 1], 1, device=device, dtype=F32)),
                )
        self.quantiles = nn.Parameter(torch.zeros(c, 1, 3, device=device, dtype=F32))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initialisers: constant matrices, U(-0.5, 0.5) biases, zero
        factors, quantiles (-init_scale, 0, init_scale)."""
        filters = (1,) + _FILTERS + (1,)
        scale = self.init_scale ** (1 / (len(_FILTERS) + 1))
        for i in range(len(_FILTERS) + 1):
            init = float(np.log(np.expm1(1 / scale / filters[i + 1])))
            getattr(self, f"_matrix{i}").fill_(init)
            bias = getattr(self, f"_bias{i}")
            bias.copy_(torch.rand(bias.shape, generator=generator, dtype=F32) - 0.5)
            if i < len(_FILTERS):
                getattr(self, f"_factor{i}").zero_()
        q = torch.tensor([-self.init_scale, 0.0, self.init_scale], dtype=F32)
        self.quantiles.copy_(q.reshape(1, 1, 3).expand(self.channels, 1, 3))

    def medians(self) -> torch.Tensor:
        """(C,) per-channel median used to round z."""
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, values: torch.Tensor, stop_gradient: bool = False) -> torch.Tensor:
        """values (C, 1, N) -> logits (C, 1, N): per stage, softplus(matrix)
        @ logits + bias, then logits += tanh(factor) * tanh(logits).  With
        `stop_gradient` the MLP's parameters take no gradient (aux_loss)."""
        def param(name):
            p = getattr(self, name)
            return p.detach() if stop_gradient else p

        logits = values
        for i in range(len(_FILTERS) + 1):
            logits = torch.matmul(F.softplus(param(f"_matrix{i}")), logits)
            logits = logits + param(f"_bias{i}")
            if i < len(_FILTERS):
                logits = logits + torch.tanh(param(f"_factor{i}")) * torch.tanh(logits)
        return logits

    def _likelihood(self, values: torch.Tensor) -> torch.Tensor:
        """values (C, 1, N) -> P(v - .5 < Z < v + .5)."""
        lower = self._logits_cumulative(values - 0.5)
        upper = self._logits_cumulative(values + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def forward(self, x: torch.Tensor, *, training: bool = False, noise=None):
        """x (B, H, W, C) -> (outputs, likelihoods), both (B, H, W, C): in
        training x plus U(-0.5, 0.5) drawn from `noise` as (C, 1, B*H*W), at
        eval x rounded around the medians; then the bounded likelihood."""
        b, h, w, c = x.shape
        values = x.to(F32).permute(3, 0, 1, 2).reshape(c, 1, -1)
        if training:
            if noise is None:
                raise ValueError("training=True requires a noise source")
            outputs = values + noise.uniform(values.shape, values.device)
        else:
            med = self.medians().reshape(c, 1, 1)
            outputs = torch.round(values - med) + med
        likelihood = lower_bound(self._likelihood(outputs), LIKELIHOOD_BOUND)
        outputs = outputs.reshape(c, b, h, w).permute(1, 2, 3, 0)
        likelihood = likelihood.reshape(c, b, h, w).permute(1, 2, 3, 0)
        return outputs.to(x.dtype), likelihood

    def aux_loss(self) -> torch.Tensor:
        """Quantile fit to the tail mass: |logits(quantiles) - (-t, 0, t)|
        summed, t = log(2 / tail_mass - 1); only `quantiles` gets its
        gradient."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = float(np.log(2.0 / self.tail_mass - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=F32, device=logits.device)
        return torch.abs(logits - target).sum()

    def host_params(self) -> dict:
        """numpy copy keyed like the JAX tree (matrix0, bias0, ..., quantiles)."""
        return {
            name.lstrip("_"): p.detach().cpu().numpy() for name, p in self.named_parameters()
        }


def build_bottleneck_tables(variables: dict, precision: int = 16) -> dict:
    """Host-side `update()`: params (numpy, JAX key names) -> rANS CDF tables
    {"cdf": (C, L) int32, "cdf_length": (C,), "offset": (C,), "medians": (C,)}."""
    params = {k: np.asarray(v) for k, v in variables.items()}
    quantiles = params["quantiles"]
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32), 0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32), 0, None)
    offset = -minima
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = np.arange(max_length)[None, :] + pmf_start[:, None]
    c = samples.shape[0]

    def np_logits(values):
        logits = values.astype(np.float32)
        for i in range(len(_FILTERS) + 1):
            m = np.asarray(params[f"matrix{i}"], np.float32)
            logits = np.einsum("cij,cjn->cin", np.logaddexp(0.0, m), logits)
            logits = logits + np.asarray(params[f"bias{i}"], np.float32)
            if i < len(_FILTERS):
                f = np.asarray(params[f"factor{i}"], np.float32)
                logits = logits + np.tanh(f) * np.tanh(logits)
        return logits

    vals = samples.reshape(c, 1, -1)
    lower = np_logits(vals - 0.5)
    upper = np_logits(vals + 0.5)
    sign = -np.sign(lower + upper)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))[:, 0, :]
    tail_mass = sigmoid(lower[:, 0, :1]) + sigmoid(-upper[:, 0, -1:])

    cdf = batched_pmf_to_cdf(pmf, tail_mass, pmf_length, max_length, precision)
    return {
        "cdf": cdf,
        "cdf_length": (pmf_length + 2).astype(np.int32),
        "offset": offset.astype(np.int32),
        "medians": medians.astype(np.float32),
    }
