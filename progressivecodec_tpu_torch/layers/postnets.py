"""Standalone post-processing networks, in NCHW.

Counterpart of `progressivecodec_tpu/layers/postnets.py`: auxiliary
refinement nets that no codec model uses.  LatentPostNet refines a decoded
latent conditioned on its entropy parameters; PostNet refines the
reconstructed image (type 0: a full-resolution GDN residual stack with two
window attentions; type 1: a 16x-downsampling autoencoder with a global
skip).  Flax infers input widths; the port takes them up front.  Children
carry JAX's names, so `models/weights.py:from_jax_module` maps JAX's
parameters onto them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.layers.blocks import GDN, Conv, Deconv, WinNoShiftAttention
from progressivecodec_tpu_torch.models.rem import ResidualBlock

__all__ = ["ResidualBlock", "ResidualBlockSmall", "ResidualBlockGDN", "LatentPostNet", "PostNet"]


class ResidualBlockSmall(nn.Module):
    """One conv3x3 -> LeakyReLU(0.01), plus the input (1x1 `skip` where the
    widths differ)."""

    def __init__(self, cin: int, out: int, device=None):
        super().__init__()
        self.conv1 = Conv(cin, out, 3, 1, device=device)
        self.skip = Conv(cin, out, 1, 1, device=device) if cin != out else None

    def forward(self, x):
        y = F.leaky_relu(self.conv1(x), 0.01)
        return y + (x if self.skip is None else self.skip(x))


class ResidualBlockGDN(nn.Module):
    """conv3x3 -> conv3x3 -> GDN (inverse on request), plus the input (1x1
    `skip` where the widths differ): the nonlinearity comes after both
    convs."""

    def __init__(self, cin: int, out: int, inverse: bool = False, device=None):
        super().__init__()
        self.conv1 = Conv(cin, out, 3, 1, device=device)
        self.conv2 = Conv(out, out, 3, 1, device=device)
        self.gdn = GDN(out, inverse=inverse, device=device)
        self.skip = Conv(cin, out, 1, 1, device=device) if cin != out else None

    def forward(self, x):
        y = self.gdn(self.conv2(self.conv1(x)))
        return y + (x if self.skip is None else self.skip(x))


class LatentPostNet(nn.Module):
    """Refines an n-channel latent from its 2n-channel entropy parameters:
    two ResidualBlock branches fused by a two-block head, plus the latent."""

    def __init__(self, n: int, device=None):
        super().__init__()
        self.enc_latent0 = ResidualBlock(n, n, device=device)
        self.enc_latent1 = ResidualBlock(n, n, device=device)
        self.enc_ent0 = ResidualBlock(2 * n, 2 * n, device=device)
        self.enc_ent1 = ResidualBlock(2 * n, n, device=device)
        self.enc0 = ResidualBlock(2 * n, 2 * n, device=device)
        self.enc1 = ResidualBlock(2 * n, n, device=device)

    def forward(self, x, entropy_params):
        f_latent = self.enc_latent1(self.enc_latent0(x))
        f_ent = self.enc_ent1(self.enc_ent0(entropy_params))
        return self.enc1(self.enc0(torch.cat([f_latent, f_ent], dim=1))) + x


class PostNet(nn.Module):
    """Image-domain refinement of a 3-channel image.  model_type 0: GDN
    residual blocks and two window attentions at full resolution; 1: four
    stride-2 convs with GDN and attention, mirrored by four deconvs, plus
    the input."""

    def __init__(self, n: int = 128, m: int = 192, model_type: int = 0, device=None):
        super().__init__()
        if model_type not in (0, 1):
            raise ValueError("model_type must be 0 or 1")
        self.model_type = model_type
        d = dict(device=device)
        if model_type == 0:
            self.res1 = ResidualBlockGDN(3, n, **d)
            self.res2 = ResidualBlockGDN(n, n, **d)
            self.attn1 = WinNoShiftAttention(n, 8, 8, 4, **d)
            self.res3 = ResidualBlockGDN(n, n, **d)
            self.res4 = ResidualBlockGDN(n, m, **d)
            self.res5 = ResidualBlockGDN(m, n, inverse=True, **d)
            self.attn2 = WinNoShiftAttention(n, 8, 8, 4, **d)
            self.res6 = ResidualBlockGDN(n, n, inverse=True, **d)
            self.res7 = ResidualBlockGDN(n, n, inverse=True, **d)
            self.res8 = ResidualBlock(n, 3, **d)
            return
        self.enc0, self.enc_gdn0 = Conv(3, n, 5, 2, **d), GDN(n, **d)
        self.enc1, self.enc_gdn1 = Conv(n, n, 5, 2, **d), GDN(n, **d)
        self.enc_attn = WinNoShiftAttention(n, 8, 8, 4, **d)
        self.enc2, self.enc_gdn2 = Conv(n, n, 5, 2, **d), GDN(n, **d)
        self.enc3 = Conv(n, m, 5, 2, **d)
        self.enc_attn2 = WinNoShiftAttention(m, 8, 4, 2, **d)
        self.dec_attn = WinNoShiftAttention(m, 8, 4, 2, **d)
        self.dec0, self.dec_gdn0 = Deconv(m, n, 5, 2, **d), GDN(n, inverse=True, **d)
        self.dec1, self.dec_gdn1 = Deconv(n, n, 5, 2, **d), GDN(n, inverse=True, **d)
        self.dec_attn2 = WinNoShiftAttention(n, 8, 8, 4, **d)
        self.dec2, self.dec_gdn2 = Deconv(n, n, 5, 2, **d), GDN(n, inverse=True, **d)
        self.dec3 = Deconv(n, 3, 5, 2, **d)

    def forward(self, x):
        if self.model_type == 0:
            y = self.attn1(self.res2(self.res1(x)))
            y = self.res5(self.res4(self.res3(y)))
            return self.res8(self.res7(self.res6(self.attn2(y))))
        y = self.enc_gdn0(self.enc0(x))
        y = self.enc_attn(self.enc_gdn1(self.enc1(y)))
        y = self.enc_attn2(self.enc3(self.enc_gdn2(self.enc2(y))))
        y = self.dec_gdn0(self.dec0(self.dec_attn(y)))
        y = self.dec_attn2(self.dec_gdn1(self.dec1(y)))
        y = self.dec3(self.dec_gdn2(self.dec2(y)))
        return y + x
