"""Scale-indexed Gaussian conditional: likelihoods, CDF-row indexes and
host tables.

Counterpart of `progressivecodec_tpu/entropy/gaussian.py`
(`gaussian_likelihood`, `gaussian_forward`, `build_indexes`,
`build_gaussian_tables`).  Scale math stays float32 so the
encoder and the decoder derive the same index from the same sigma bits.
"""

from __future__ import annotations

import numpy as np
import scipy.special
import scipy.stats
import torch

from progressivecodec_tpu_torch.entropy.cdf import batched_pmf_to_cdf
from progressivecodec_tpu_torch.ops.math import lower_bound

SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) through erfc, which keeps precision in the tails."""
    return 0.5 * torch.special.erfc(-(2**-0.5) * x)


def gaussian_likelihood(inputs: torch.Tensor, scales: torch.Tensor,
                        means: torch.Tensor | None = None,
                        scale_bound: float = SCALE_BOUND) -> torch.Tensor:
    """P(v - .5 < Y < v + .5) for Y ~ N(means, scales^2), bounded below by
    LIKELIHOOD_BOUND."""
    values = inputs if means is None else inputs - means
    values = torch.abs(values.to(torch.float32))
    scales = lower_bound(scales.to(torch.float32), scale_bound)
    upper = standardized_cumulative((0.5 - values) / scales)
    lower = standardized_cumulative((-0.5 - values) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def gaussian_forward(inputs: torch.Tensor, scales: torch.Tensor,
                     means: torch.Tensor | None = None, *, training: bool = False,
                     noise=None):
    """(outputs, likelihood): in training the inputs plus U(-0.5, 0.5) drawn
    from `noise` (`ops/noise.py`) in the inputs' shape, at eval the inputs
    rounded around the means (or rounded); then the likelihood of the
    outputs."""
    if training:
        if noise is None:
            raise ValueError("training=True requires a noise source")
        outputs = inputs + noise.uniform(inputs.shape, inputs.device)
    elif means is None:
        outputs = torch.round(inputs)
    else:
        outputs = torch.round(inputs - means) + means
    return outputs, gaussian_likelihood(outputs, scales, means)


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float = SCALE_BOUND) -> torch.Tensor:
    """Per-element CDF row: (levels - 1) - #{s in table[:-1] : sigma <= s},
    counted in float32."""
    scales = lower_bound(scales.to(torch.float32), scale_bound)
    table = scale_table.to(device=scales.device, dtype=torch.float32)[:-1]
    count = (scales[..., None] <= table).sum(dim=-1, dtype=torch.int32)
    return (scale_table.shape[0] - 1) - count


def build_gaussian_tables(scale_table: np.ndarray, tail_mass: float = 1e-9,
                          precision: int = 16) -> dict:
    """Host-side `update()`: scale table -> rANS CDF tables."""
    scale_table = np.asarray(scale_table, dtype=np.float64)
    multiplier = -scipy.stats.norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length, dtype=np.int32) - pmf_center[:, None]).astype(
        np.float32
    )
    samples_scale = scale_table.astype(np.float32)[:, None]

    def _cum(x):
        return 0.5 * scipy.special.erfc(-(2**-0.5) * x)

    upper = _cum((0.5 - samples) / samples_scale)
    lower = _cum((-0.5 - samples) / samples_scale)
    pmf = upper - lower
    tail = 2 * lower[:, :1]

    cdf = batched_pmf_to_cdf(pmf, tail, pmf_length, max_length, precision)
    return {
        "cdf": cdf,
        "cdf_length": (pmf_length + 2).astype(np.int32),
        "offset": (-pmf_center).astype(np.int32),
        "scale_table": scale_table.astype(np.float32),
    }
