"""The 3-level UNet of the optional `u_net_post` image refinement, NCHW.

Counterpart of `progressivecodec_tpu/layers/unet.py`: residual conv blocks
with squeeze-and-excitation gates, four ResBlocks at the bottleneck and
pixel-shuffle upsampling.  Module names follow the reference's tree
(`conv1.conv.0.weight`, `conv1.conv.3.fc.0.weight`, `context_refine.0.conv1.weight`,
`up3.0.weight`), so its state dict loads with `strict=True`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.layers.blocks import Conv, SubpelConv

F32 = torch.float32


class SELayer(nn.Module):
    """Channel gate: x * sigmoid(W2 relu(W1 mean_hw(x))), no biases."""

    def __init__(self, c: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(c, c // reduction, bias=False, device=device, dtype=F32), nn.ReLU(),
            nn.Linear(c // reduction, c, bias=False, device=device, dtype=F32), nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ConvBlockResidual(nn.Module):
    """up_dim(x) + SE(conv3(leaky_relu(conv3(x))))."""

    def __init__(self, cin: int, out: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(cin, out, 3, 1, device=device), nn.LeakyReLU(0.01),
            Conv(out, out, 3, 1, device=device), SELayer(out, device=device),
        )
        self.up_dim = Conv(cin, out, 1, 1, device=device)

    def forward(self, x):
        return self.up_dim(x) + self.conv(x)


class ResBlock(nn.Module):
    """x + conv3(relu(conv3(relu(x))))."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv1 = Conv(c, c, 3, 1, device=device)
        self.conv2 = Conv(c, c, 3, 1, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class UNet(nn.Module):
    def __init__(self, cin: int = 3, out_ch: int = 16, device=None):
        super().__init__()
        self.conv1 = ConvBlockResidual(cin, 32, device=device)
        self.conv2 = ConvBlockResidual(32, 64, device=device)
        self.conv3 = ConvBlockResidual(64, 128, device=device)
        self.context_refine = nn.Sequential(*[ResBlock(128, device=device) for _ in range(4)])
        self.up3 = SubpelConv(128, 64, 2, kernel_size=1, device=device)
        self.up_conv3 = ConvBlockResidual(128, 64, device=device)
        self.up2 = SubpelConv(64, 32, 2, kernel_size=1, device=device)
        self.up_conv2 = ConvBlockResidual(64, out_ch, device=device)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(F.max_pool2d(x1, 2))
        x3 = self.context_refine(self.conv3(F.max_pool2d(x2, 2)))
        d3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=1))
        return self.up_conv2(torch.cat([x1, self.up2(d3)], dim=1))


def refine_net(device=None) -> nn.Sequential:
    """The u_net_post refinement: UNet(3 -> 16) then a 3x3 conv to RGB."""
    return nn.Sequential(UNet(3, 16, device=device), Conv(16, 3, 3, 1, device=device))
