"""Variance-aware latent masking.

Counterpart of `progressivecodec_tpu/layers/masking.py` for the policies
the codec reaches: point-based-std, two-levels, three-levels-std,
scalable_res and an importance map (`cust_map`), and `apply_mask_noise`.

The decoder recomputes the mask from sigma alone, so the mask must be a
bit-exact function of sigma.  `quantile_mask` therefore reproduces
`jnp.quantile(..., method="linear")` exactly: sort, then JAX's float32
index and weight formula.  `torch.quantile` is not used: it interpolates
with `lerp` and refuses inputs above 2^24 elements.
"""

from __future__ import annotations

import numpy as np
import torch

from progressivecodec_tpu_torch.ops.math import ste_round

F32 = torch.float32


def row_quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of each row of a 2-D float32 tensor,
    computed as JAX computes it: index q*(n-1), its floor and ceil, and the
    two weights, all in float32 (a row holding NaN gives NaN)."""
    n = flat.shape[1]
    srt = torch.sort(flat, dim=1).values
    qf = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(qf), np.ceil(qf)
    high_w = qf - low
    low_w = np.float32(1.0) - high_w
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    w = lambda v: torch.tensor(v, dtype=F32, device=flat.device)  # noqa: E731
    out = srt[:, lo_i] * w(low_w) + srt[:, hi_i] * w(high_w)
    return torch.where(torch.isnan(flat).any(dim=1), w(np.nan), out)


def quantile_mask(values: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """Per-image mask keeping the top `keep_frac` fraction of elements:
    values (B, ...) ranked per batch element; mask = values >= quantile."""
    b = values.shape[0]
    flat = values.reshape(b, -1).to(F32)
    q = row_quantile(flat, 1.0 - keep_frac)
    return (flat >= q[:, None]).reshape(values.shape).to(F32)


def channel_mask(scale: torch.Tensor, *, pr: float, mask_pol: str = "point-based-std",
                 slice_index: int = 0, dim_chunk: int = 32, division_channel: int = 320,
                 cust_map: torch.Tensor | None = None) -> torch.Tensor:
    """Enhancement mask for one slice; scale (B, H, W, dim_chunk)."""
    ones = lambda: torch.ones_like(scale, dtype=F32)  # noqa: E731
    zeros = lambda: torch.zeros_like(scale, dtype=F32)  # noqa: E731
    if cust_map is not None:
        if pr >= 10:
            return ones()
        if pr <= 0:
            return zeros()
        return quantile_mask(cust_map, min(pr, 10) * 0.1)
    if mask_pol == "point-based-std":
        if pr >= 10:
            return ones()
        if pr <= 0:
            return zeros()
        return quantile_mask(scale, min(pr, 10) * 0.1)
    if mask_pol == "two-levels":
        return zeros() if pr == 0 else ones()
    if mask_pol == "three-levels-std":
        if pr == 0:
            return zeros()
        if pr == 2:
            return ones()
        return quantile_mask(scale, 0.2)
    if mask_pol == "scalable_res":
        if pr == 0:
            return zeros()
        if pr == 10:
            return ones()
        ones_channel = int(division_channel * pr * 0.1)
        ch_start = slice_index * dim_chunk
        ch_end = dim_chunk * (slice_index + 1)
        if ones_channel >= ch_end:
            return ones()
        if ones_channel < ch_start:
            return zeros()
        rem = ones_channel % dim_chunk
        ch = torch.arange(scale.shape[-1], device=scale.device)
        return (ch >= rem).to(F32).expand(scale.shape).contiguous()
    raise NotImplementedError(f"mask policy {mask_pol!r}")


def stacked_channel_mask(scale_stack: torch.Tensor, *, pr: float,
                         mask_pol: str = "point-based-std", dim_chunk: int = 32,
                         division_channel: int = 320,
                         cust_map: torch.Tensor | None = None) -> torch.Tensor:
    """Mask over all enhancement slices at once; scale_stack (S, B, H, W,
    dim_chunk), ranked per (slice, image).  cust_map, if given, is an
    importance map of the same shape that replaces sigma as the ranking."""
    s, b = scale_stack.shape[0], scale_stack.shape[1]
    ones = lambda: torch.ones_like(scale_stack, dtype=F32)  # noqa: E731
    zeros = lambda: torch.zeros_like(scale_stack, dtype=F32)  # noqa: E731

    def ranked(src, q):
        flat = src.reshape(s * b, -1).to(F32)
        q = row_quantile(flat, q)
        return (flat >= q[:, None]).reshape(scale_stack.shape).to(F32)

    if cust_map is not None:
        if pr >= 10:
            return ones()
        if pr <= 0:
            return zeros()
        return ranked(cust_map, 1.0 - min(pr, 10) * 0.1)
    if mask_pol == "point-based-std":
        if pr >= 10:
            return ones()
        if pr <= 0:
            return zeros()
        return ranked(scale_stack, 1.0 - min(pr, 10) * 0.1)
    if mask_pol == "two-levels":
        return zeros() if pr == 0 else ones()
    if mask_pol == "three-levels-std":
        if pr == 0:
            return zeros()
        if pr == 2:
            return ones()
        return ranked(scale_stack, 0.8)
    if mask_pol == "scalable_res":
        if pr == 0:
            return zeros()
        if pr == 10:
            return ones()
        ones_channel = int(division_channel * pr * 0.1)
        per_slice = np.zeros((s, dim_chunk), np.float32)
        for i in range(s):
            lo, hi = i * dim_chunk, (i + 1) * dim_chunk
            if ones_channel >= hi:
                per_slice[i] = 1.0
            elif ones_channel >= lo:
                per_slice[i, ones_channel % dim_chunk :] = 1.0
        per_slice = torch.as_tensor(per_slice, device=scale_stack.device)
        return per_slice[:, None, None, None, :].expand(scale_stack.shape).contiguous()
    raise NotImplementedError(f"stacked mask policy {mask_pol!r}")


def apply_mask_noise(mask: torch.Tensor, training: bool = False) -> torch.Tensor:
    """A straight-through round in training, a hard round at eval."""
    return ste_round(mask) if training else torch.round(mask)
