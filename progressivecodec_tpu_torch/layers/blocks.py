"""NN building blocks in NCHW: conv layers, GDN, shifted window attention.

Counterpart of `progressivecodec_tpu/layers/blocks.py`.  Module and
parameter names follow the reference's torch module tree, so a state dict
named like the reference (`models/weights.py:from_jax_params`) loads with
`load_state_dict(strict=True)`.  Every parameter is float32 whatever the
process's default dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.ops.conv import conv2d, deconv2d
from progressivecodec_tpu_torch.ops.math import nonneg_init, nonneg_reparam

F32 = torch.float32


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


class Conv(nn.Conv2d):
    """Conv2d(k, stride, padding=k//2)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, stride: int = 2,
                 device=None):
        super().__init__(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                         device=device, dtype=F32)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, stride=self.stride[0])


class Deconv(nn.ConvTranspose2d):
    """ConvTranspose2d(k, stride, padding=k//2, output_padding=stride-1)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, stride: int = 2,
                 device=None):
        super().__init__(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                         output_padding=stride - 1, device=device, dtype=F32)

    def forward(self, x):
        return deconv2d(x, self.weight, self.bias, stride=self.stride[0])


class SubpelConv(nn.Sequential):
    """3x3 conv + pixel shuffle upsampling: keys `0.weight`, `0.bias`."""

    def __init__(self, cin: int, cout: int, r: int = 2, kernel_size: int = 3, device=None):
        super().__init__(Conv(cin, cout * r * r, kernel_size, 1, device=device),
                         nn.PixelShuffle(r))


class GDN(nn.Module):
    """Generalized divisive normalization, y = x / sqrt(beta + sum_j gamma[o,j] x_j^2),
    with beta and gamma in the non-negative reparam space; the inverse
    multiplies by the square root instead."""

    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, device=None):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.gamma_init = gamma_init
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels, device=device, dtype=F32)))
        self.gamma = nn.Parameter(
            nonneg_init(gamma_init * torch.eye(channels, device=device, dtype=F32))
        )

    def forward(self, x):
        beta = nonneg_reparam(self.beta, self.beta_min)
        gamma = nonneg_reparam(self.gamma)
        c = gamma.shape[0]
        norm = F.conv2d(x * x, gamma.reshape(c, c, 1, 1), beta)
        return x * torch.sqrt(norm) if self.inverse else x * torch.rsqrt(norm)


class GDN1(GDN):
    """Simplified GDN: y = x / (beta + sum_j gamma[o,j] |x_j|); the inverse
    multiplies instead.  Same parameters as GDN."""

    def forward(self, x):
        beta = nonneg_reparam(self.beta, self.beta_min)
        gamma = nonneg_reparam(self.gamma)
        c = gamma.shape[0]
        norm = F.conv2d(torch.abs(x), gamma.reshape(c, c, 1, 1), beta)
        return x * norm if self.inverse else x / norm


def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """Relative-position index table for a (wh, ww) window."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int, fill: float = -1e9) -> np.ndarray:
    """Additive (nW, ws*ws, ws*ws) mask for shifted windows: `fill` between
    tokens of different regions; the default -1e9 stays a true mask for any
    logits (STF's Swin blocks add Swin's -100, `layers/swin.py`)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, h - window), slice(h - window, h - shift), slice(h - shift, None)):
        for ws in (slice(0, w - window), slice(w - window, w - shift), slice(w - shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh, nw = h // window, w // window
    win = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, fill, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside one window, with relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim, device=device, dtype=F32)
        self.proj = nn.Linear(dim, dim, device=device, dtype=F32)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads, device=device, dtype=F32)
        )
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(window_size, window_size).reshape(-1),
                            device=device),
            persistent=False,
        )

    def forward(self, xw, mask=None, n_windows_per_image: int = 1):
        """xw (B_, n, c) window tokens; mask (nW, n, n) additive or None."""
        b_, n, c = xw.shape
        heads = self.num_heads
        hd = c // heads
        qkv = F.linear(xw, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q * hd**-0.5, k.transpose(-2, -1))
        rel = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + rel.reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            attn = attn.reshape(-1, n_windows_per_image, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return F.linear(out, self.proj.weight, self.proj.bias)


class WinBasedAttention(nn.Module):
    """Swin-style (shifted) window attention block with a residual."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0, device=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn = WindowAttention(dim, num_heads, window_size, device=device)
        self._masks: dict = {}

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_attn_mask(h, w, self.window_size, self.shift_size), device=device
            )
        return self._masks[key]

    def forward(self, x):
        b, c, h, w = x.shape
        ws, ss = self.window_size, self.shift_size
        nh, nw = h // ws, w // ws
        xs = x.permute(0, 2, 3, 1)
        mask = None
        if ss > 0:
            xs = torch.roll(xs, shifts=(-ss, -ss), dims=(1, 2))
            mask = self._mask(h, w, x.device)
        xw = xs.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, ws * ws, c)
        out = self.attn(xw, mask, nh * nw)
        out = out.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if ss > 0:
            out = torch.roll(out, shifts=(ss, ss), dims=(1, 2))
        return x + out.permute(0, 3, 1, 2)


class ResidualUnit(nn.Module):
    """conv1x1 -> GELU -> conv3x3 -> GELU -> conv1x1, skip, GELU."""

    def __init__(self, n: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(n, n // 2, 1, 1, device=device), nn.GELU(),
            Conv(n // 2, n // 2, 3, 1, device=device), nn.GELU(),
            Conv(n // 2, n, 1, 1, device=device),
        )

    def forward(self, x):
        return gelu(x + self.conv(x))


class WinNoShiftAttention(nn.Module):
    """Two-branch gated attention block: x + conv_a(x) * sigmoid(conv_b(x)),
    where conv_b starts with the (shifted) window attention."""

    def __init__(self, n: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0, device=None):
        super().__init__()
        self.conv_a = nn.Sequential(*[ResidualUnit(n, device=device) for _ in range(3)])
        self.conv_b = nn.Sequential(
            WinBasedAttention(n, num_heads, window_size, shift_size, device=device),
            *[ResidualUnit(n, device=device) for _ in range(3)],
            Conv(n, n, 1, 1, device=device),
        )

    def forward(self, x):
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(x))


class ConvStack5(nn.Sequential):
    """The 5-conv 3x3 parameter-prediction stack: widths 224-176-128-64-out
    with GELU between (keys `0.`, `2.`, `4.`, `6.`, `8.`)."""

    def __init__(self, cin: int, out: int = 32, widths: Sequence[int] = (224, 176, 128, 64),
                 device=None):
        layers: list[nn.Module] = []
        c = cin
        for wd in widths:
            layers += [Conv(c, wd, 3, 1, device=device), nn.GELU()]
            c = wd
        layers.append(Conv(c, out, 3, 1, device=device))
        super().__init__(*layers)
