"""Swin-transformer layers of STF (Zou, Song and Zhang, CVPR 2022), in the
token layout (B, H*W, C) of github.com/Googolxx/STF `compressai/models/stf.py`.

Module and parameter names follow that file's tree (`blocks.<j>.norm1`,
`blocks.<j>.attn.qkv`, `blocks.<j>.mlp.fc1`, `downsample.reduction`, ...),
so its state dict loads with `load_state_dict(strict=True)`; the
relative-position index is recomputed, not stored (`WindowAttention`).

A stage (`SwinStage`) runs its blocks, even ones on plain windows and odd
ones on windows shifted by -window/2 with the region mask (SW-MSA), each
pre-norm: x + W-MSA(LN(x)), then x + MLP(LN(x)).  A map whose sides are not
multiples of the window is zero-padded after the norm and cropped after the
attention, as STF pads it; the mask is built on the padded map.  The stage
then merges 2x2 patches (analysis) or splits each token into four
(synthesis).

Spans (`utils/profiling.py`): `swin:embed`, `swin:attn` (norm, roll,
partition, attention, reverse, roll back, residual), `swin:mlp`,
`swin:merge`, `swin:split`, and `swin:end` around the synthesis's last
convolutions; the counter `swin:windows` adds B * nW for every block.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.layers.blocks import WindowAttention, _shift_attn_mask
from progressivecodec_tpu_torch.utils.profiling import count, span

F32 = torch.float32
# STF's (and Swin's) additive mask between regions of a shifted window
MASK_FILL = -100.0


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), windows in row-major order."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(xw: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    c = xw.shape[-1]
    b = xw.shape[0] // ((h // ws) * (w // ws))
    return xw.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class Mlp(nn.Module):
    """Linear(C, hidden), GELU, Linear(hidden, C)."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=F32)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=F32)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One pre-norm Swin block on a (B, H*W, C) map of H x W tokens."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, device=None):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, device=device, dtype=F32)
        self.attn = WindowAttention(dim, num_heads, window_size, device=device)
        self.norm2 = nn.LayerNorm(dim, device=device, dtype=F32)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    @span("swin:attn")
    def attend(self, x, h: int, w: int, mask):
        """x + W-MSA(LN(x)), or SW-MSA with the stage's mask."""
        b, _, c = x.shape
        ws, ss = self.window_size, self.shift_size
        xs = self.norm1(x).reshape(b, h, w, c)
        pad_r, pad_b = -w % ws, -h % ws
        if pad_r or pad_b:
            xs = F.pad(xs, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if ss:
            xs = torch.roll(xs, shifts=(-ss, -ss), dims=(1, 2))
        n_win = (hp // ws) * (wp // ws)
        count("swin:windows", b * n_win)
        out = self.attn(window_partition(xs, ws), mask if ss else None, n_win)
        out = window_reverse(out, ws, hp, wp)
        if ss:
            out = torch.roll(out, shifts=(ss, ss), dims=(1, 2))
        if pad_r or pad_b:
            out = out[:, :h, :w, :].contiguous()
        return x + out.reshape(b, h * w, c)

    @span("swin:mlp")
    def feed_forward(self, x):
        return x + self.mlp(self.norm2(x))

    def forward(self, x, h: int, w: int, mask):
        return self.feed_forward(self.attend(x, h, w, mask))


class PatchMerging(nn.Module):
    """2x2 patches -> one token: x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
    x[1::2, 1::2] concatenated, LayerNorm(4C), Linear(4C, 2C) without bias;
    an odd side is zero-padded first."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device, dtype=F32)
        self.norm = nn.LayerNorm(4 * dim, device=device, dtype=F32)

    @span("swin:merge")
    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c))), (h + 1) // 2, (w + 1) // 2


class PatchSplit(nn.Module):
    """One token -> 2x2: LayerNorm(C), Linear(C, 2C) without bias, then a
    pixel shuffle of the 2C channels into C/2 channels at twice the size."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.reduction = nn.Linear(dim, 2 * dim, bias=False, device=device, dtype=F32)
        self.norm = nn.LayerNorm(dim, device=device, dtype=F32)

    @span("swin:split")
    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        x = self.reduction(self.norm(x))
        x = F.pixel_shuffle(x.permute(0, 2, 1).contiguous().reshape(b, 2 * c, h, w), 2)
        return x.permute(0, 2, 3, 1).contiguous().reshape(b, 4 * n, -1), 2 * h, 2 * w


class SwinStage(nn.Module):
    """STF's BasicLayer: `depth` blocks, alternately plain and shifted, then
    `downsample` (PatchMerging, PatchSplit or None)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, downsample=None, device=None):
        super().__init__()
        self.window_size = window_size
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size, 0 if j % 2 == 0 else window_size // 2,
                      mlp_ratio, device=device)
            for j in range(depth)
        ])
        self.downsample = downsample(dim, device=device) if downsample is not None else None
        self._masks: dict = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        """The region mask of the padded map, made once per size: a host
        copy to the card is a sync, which the codec's fragments never make
        after the first request of a size."""
        key = (hp, wp, str(device))
        if key not in self._masks:
            ws = self.window_size
            self._masks[key] = torch.as_tensor(
                _shift_attn_mask(hp, wp, ws, ws // 2, fill=MASK_FILL), device=device)
        return self._masks[key]

    def forward(self, x, h: int, w: int):
        ws = self.window_size
        mask = None
        if len(self.blocks) > 1:
            mask = self._mask(-(-h // ws) * ws, -(-w // ws) * ws, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, mask)
        if self.downsample is None:
            return x, h, w
        return self.downsample(x, h, w)


class PatchEmbed(nn.Module):
    """Conv(3, C, k=patch, stride=patch) on an image zero-padded to a
    multiple of the patch, then LayerNorm: (B, 3, H, W) -> tokens."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size, device=device, dtype=F32)
        self.norm = nn.LayerNorm(embed_dim, device=device, dtype=F32)

    @span("swin:embed")
    def forward(self, x):
        """-> (tokens (B, h*w, C), h, w)."""
        p = self.patch_size
        pad_r, pad_b = -x.shape[3] % p, -x.shape[2] % p
        if pad_r or pad_b:
            x = F.pad(x, (0, pad_r, 0, pad_b))
        x = self.proj(x)
        return self.norm(x.flatten(2).transpose(1, 2)), x.shape[2], x.shape[3]
