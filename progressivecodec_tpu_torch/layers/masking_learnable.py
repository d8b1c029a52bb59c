"""The learnable ("three-levels-learnable") mask stack, NCHW.

Counterpart of `progressivecodec_tpu/layers/masking_learnable.py`:
conv3 -> ReLU -> conv3 s2 -> ReLU -> subpel x2 -> ReLU -> conv3 -> sigmoid,
with the reference's indices (`0.`, `2.`, `4.0.`, `6.`).
"""

from __future__ import annotations

import torch.nn as nn

from progressivecodec_tpu_torch.layers.blocks import Conv, SubpelConv


class LearnableMaskStack(nn.Sequential):
    def __init__(self, cin: int, out: int = 32, device=None):
        super().__init__(
            Conv(cin, cin, 3, 1, device=device), nn.ReLU(),
            Conv(cin, cin, 3, 2, device=device), nn.ReLU(),
            SubpelConv(cin, out, 2, device=device), nn.ReLU(),
            Conv(out, out, 3, 1, device=device), nn.Sigmoid(),
        )
