"""Layers of TCM, the mixed Transformer-CNN codec of Liu, Sun and Katto
(CVPR 2023), github.com/jmliu206/LIC_TCM `models/tcm.py`, with CompressAI's
residual blocks and attention block as that file uses them.

Module and parameter names follow that file's tree (`trans_block.msa.
embedding_layer`, `trans_block.msa.relative_position_params` of shape
(heads, 2 ws - 1, 2 ws - 1), `conv1_1`, `conv_block.conv1`,
`non_local_block.block_2.ln1`, `subpel_conv.0`, `igdn`, ...), so its state
dict loads with `load_state_dict(strict=True)`.

The operations follow TCM's order and layout, so that the plain reference
(`benchmark/reference/tcm.py`) reads the same bits: NCHW convolutions; the
Transformer half of a ConvTransBlock on the (B, H, W, C) view that a permute
of its NCHW half gives; window attention as matmul, times head_dim^-0.5,
plus the relative-position bias, -inf on the shifted windows' cross-region
pairs, softmax, matmul.

Spans (`utils/profiling.py`): `tcm:ctb` around each ConvTransBlock, `tcm:res`
around each residual block with stride or upsampling and g_s's last
sub-pixel convolution, and the name a SWAtten is given (`swatten:mean`,
`swatten:scale`) around it; the counter `tcm:windows` adds B * nW for every
W-MSA or SW-MSA call.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.layers.blocks import GDN, Conv, SubpelConv, _rel_pos_index, _shift_attn_mask
from progressivecodec_tpu_torch.layers.swin import window_partition, window_reverse
from progressivecodec_tpu_torch.models.rem import ResidualBlock
from progressivecodec_tpu_torch.utils.profiling import count, span

F32 = torch.float32
LEAKY_SLOPE = 0.01
MLP_RATIO = 4


class WMSA(nn.Module):
    """SCUNet's window multi-head self-attention on (B, H, W, C) tokens, on
    plain windows or, `shifted`, on windows rolled by -ws/2."""

    def __init__(self, dim: int, head_dim: int, window_size: int, shifted: bool, device=None):
        super().__init__()
        self.head_dim, self.window_size, self.shifted = head_dim, window_size, shifted
        self.n_heads = dim // head_dim
        ws = window_size
        self.relative_position_params = nn.Parameter(
            torch.zeros(self.n_heads, 2 * ws - 1, 2 * ws - 1, device=device, dtype=F32))
        self.embedding_layer = nn.Linear(dim, 3 * dim, device=device, dtype=F32)
        self.linear = nn.Linear(dim, dim, device=device, dtype=F32)
        self.register_buffer("relative_position_index",
                             torch.as_tensor(_rel_pos_index(ws, ws).reshape(-1), device=device),
                             persistent=False)
        self._masks: dict = {}

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        """(1, 1, nW, n, n), True on the cross-region pairs of the shifted
        windows (TCM's `generate_mask` marks them in the last row and column
        of windows, which is Swin's region mask); made once per size, so the
        fragments copy nothing to the card after a size's first request."""
        key = (h, w, str(device))
        if key not in self._masks:
            m = _shift_attn_mask(h, w, self.window_size, self.window_size // 2) != 0
            self._masks[key] = torch.as_tensor(m, device=device)[None, None]
        return self._masks[key]

    def forward(self, x):
        b, h, w, c = x.shape
        ws, hd, heads = self.window_size, self.head_dim, self.n_heads
        n, nw = ws * ws, (h // ws) * (w // ws)
        count("tcm:windows", b * nw)
        if self.shifted:
            x = torch.roll(x, shifts=(-(ws // 2), -(ws // 2)), dims=(1, 2))
        xw = window_partition(x, ws).reshape(b, nw, n, c)
        qkv = F.linear(xw, self.embedding_layer.weight, self.embedding_layer.bias)
        q, k, v = qkv.reshape(b, nw, n, 3 * heads, hd).permute(3, 0, 1, 2, 4).chunk(3, dim=0)
        sim = torch.matmul(q, k.transpose(-2, -1)) * hd**-0.5
        rel = self.relative_position_params.reshape(heads, -1)[:, self.relative_position_index]
        sim = sim + rel.reshape(heads, n, n)[:, None, None]
        if self.shifted:
            sim = sim.masked_fill(self._mask(h, w, x.device), float("-inf"))
        out = torch.matmul(torch.softmax(sim, dim=-1), v)
        out = out.permute(1, 2, 3, 0, 4).reshape(b, nw, n, c)
        out = F.linear(out, self.linear.weight, self.linear.bias)
        out = window_reverse(out.reshape(b * nw, n, c), ws, h, w)
        if self.shifted:
            out = torch.roll(out, shifts=(ws // 2, ws // 2), dims=(1, 2))
        return out


class Block(nn.Module):
    """TCM's pre-norm Swin block on (B, H, W, C): x + MSA(LN(x)), then
    x + MLP(LN(x)), the MLP Linear(C, 4C), GELU, Linear(4C, C)."""

    def __init__(self, dim: int, head_dim: int, window_size: int, shifted: bool, device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, device=device, dtype=F32)
        self.msa = WMSA(dim, head_dim, window_size, shifted, device=device)
        self.ln2 = nn.LayerNorm(dim, device=device, dtype=F32)
        self.mlp = nn.Sequential(nn.Linear(dim, MLP_RATIO * dim, device=device, dtype=F32), nn.GELU(),
                                 nn.Linear(MLP_RATIO * dim, dim, device=device, dtype=F32))

    def forward(self, x):
        x = x + self.msa(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ResidualBlockWithStride(nn.Module):
    """CompressAI's: conv3x3 stride 2, LeakyReLU, conv3x3, GDN, plus a
    conv1x1 stride 2 skip."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, 2, device=device)
        self.conv2 = Conv(cout, cout, 3, 1, device=device)
        self.gdn = GDN(cout, device=device)
        self.skip = Conv(cin, cout, 1, 2, device=device)

    @span("tcm:res")
    def forward(self, x):
        out = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        return self.gdn(self.conv2(out)) + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    """CompressAI's: subpel conv3x3 (x2), LeakyReLU, conv3x3, inverse GDN,
    plus a subpel conv3x3 skip."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.subpel_conv = SubpelConv(cin, cout, 2, device=device)
        self.conv = Conv(cout, cout, 3, 1, device=device)
        self.igdn = GDN(cout, inverse=True, device=device)
        self.upsample = SubpelConv(cin, cout, 2, device=device)

    @span("tcm:res")
    def forward(self, x):
        out = F.leaky_relu(self.subpel_conv(x), LEAKY_SLOPE)
        return self.igdn(self.conv(out)) + self.upsample(x)


class SubpelOut(SubpelConv):
    """g_s's last sub-pixel convolution, in a `tcm:res` span."""

    @span("tcm:res")
    def forward(self, x):
        return super().forward(x)


class ConvTransBlock(nn.Module):
    """On 2 * `half` channels: conv1x1, split into a CNN half (x +
    ResidualBlock(x), CompressAI's block as REM's banks use it) and a
    Transformer half (a `Block` on the permuted view), concatenated,
    conv1x1, plus the input."""

    def __init__(self, half: int, head_dim: int, window_size: int, shifted: bool, device=None):
        super().__init__()
        self.half = half
        self.trans_block = Block(half, head_dim, window_size, shifted, device=device)
        self.conv1_1 = Conv(2 * half, 2 * half, 1, 1, device=device)
        self.conv1_2 = Conv(2 * half, 2 * half, 1, 1, device=device)
        self.conv_block = ResidualBlock(half, half, device=device)

    @span("tcm:ctb")
    def forward(self, x):
        conv_x, trans_x = torch.split(self.conv1_1(x), (self.half, self.half), dim=1)
        conv_x = self.conv_block(conv_x) + conv_x
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1))
        return x + self.conv1_2(torch.cat((conv_x, trans_x.permute(0, 3, 1, 2)), dim=1))


class AttentionUnit(nn.Module):
    """The residual unit of CompressAI's AttentionBlock: conv1x1 (C -> C/2),
    ReLU, conv3x3, ReLU, conv1x1 (-> C), plus the input, ReLU."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(ch, ch // 2, 1, 1, device=device), nn.ReLU(),
            Conv(ch // 2, ch // 2, 3, 1, device=device), nn.ReLU(),
            Conv(ch // 2, ch, 1, 1, device=device),
        )

    def forward(self, x):
        return F.relu(self.conv(x) + x)


class SwinBlock(nn.Module):
    """TCM's two-block Swin on NCHW: a plain-window block, then a shifted
    one, on the (B, H, W, C) view.  TCM pads a map no larger than one window
    first; the port refuses such images instead (`models/tcm.py`)."""

    def __init__(self, dim: int, head_dim: int, window_size: int, device=None):
        super().__init__()
        self.block_1 = Block(dim, head_dim, window_size, False, device=device)
        self.block_2 = Block(dim, head_dim, window_size, True, device=device)

    def forward(self, x):
        return self.block_2(self.block_1(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)


class SWAtten(nn.Module):
    """conv1x1 (C -> inter), CompressAI's AttentionBlock on `inter` channels
    whose gate branch conv_b reads a two-block Swin of its input, conv1x1
    (inter -> C); in a span named `span_name`."""

    def __init__(self, ch: int, inter: int, head_dim: int, window_size: int, span_name: str,
                 device=None):
        super().__init__()
        self.span_name = span_name
        self.conv_a = nn.Sequential(*[AttentionUnit(inter, device=device) for _ in range(3)])
        self.conv_b = nn.Sequential(*[AttentionUnit(inter, device=device) for _ in range(3)],
                                    Conv(inter, inter, 1, 1, device=device))
        self.non_local_block = SwinBlock(inter, head_dim, window_size, device=device)
        self.in_conv = Conv(ch, inter, 1, 1, device=device)
        self.out_conv = Conv(inter, ch, 1, 1, device=device)

    def forward(self, x):
        with span(self.span_name):
            x = self.in_conv(x)
            z = self.non_local_block(x)
            return self.out_conv(self.conv_a(x) * torch.sigmoid(self.conv_b(z)) + x)
