"""Image quality metrics: PSNR and MS-SSIM on NHWC tensors.

Counterpart of `progressivecodec_tpu/utils/metrics.py`: the standard
MS-SSIM (Wang et al. 2003) over 5 scales, an 11x11 Gaussian window of
sigma 1.5, weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), K = (0.01,
0.03).  The window is applied as two 1-D passes of float32 multiply-adds:
SSIM's variances E[x^2] - mu^2 cancel catastrophically, and a convolution
could run in TF32 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a.to(F32) - b.to(F32)) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp_min(mse, 1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1-D Gaussian whose outer product is the 2-D window."""
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _filter2(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable Gaussian filter of x (B, H, W, C)."""
    k = g.shape[0]
    x = (x.unfold(1, k, 1) * g).sum(-1)
    return (x.unfold(2, k, 1) * g).sum(-1)


def _ssim_pair(x, y, g, max_val):
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _filter2(x, g)
    mu_y = _filter2(y, g)
    sxx = _filter2(x * x, g) - mu_x**2
    syy = _filter2(y * y, g) - mu_y**2
    sxy = _filter2(x * y, g) - mu_x * mu_y
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * cs
    return torch.mean(ssim), torch.mean(cs)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """a, b (B, H, W, C) in [0, max_val] -> scalar MS-SSIM."""
    g = torch.as_tensor(_gaussian_window(), device=a.device)
    x, y = a.to(F32), b.to(F32)
    vals = []
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        ssim, cs = _ssim_pair(x, y, g, max_val)
        if i == len(_MSSSIM_WEIGHTS) - 1:
            vals.append(torch.clamp_min(ssim, 0.0) ** w)
        else:
            vals.append(torch.clamp_min(cs, 0.0) ** w)
            x, y = _avg_pool2(x), _avg_pool2(y)
    return torch.prod(torch.stack(vals))


def ms_ssim_db(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """-10 log10(1 - MS-SSIM)."""
    return -10.0 * torch.log10(torch.clamp_min(1.0 - ms_ssim(a, b, max_val), 1e-12))
