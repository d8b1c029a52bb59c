"""Analysis / synthesis / hyper transform stacks, NCHW, and the ChARM
base-slice fragments the two model families share.

Counterpart of `progressivecodec_tpu/models/transforms.py`.  Each stack is
an `nn.Sequential` whose indices match the reference's module tree
(`g_a.0.weight`, `h_mean_s.2.0.weight`, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from progressivecodec_tpu_torch.entropy.gaussian import build_indexes, gaussian_forward
from progressivecodec_tpu_torch.layers.blocks import (
    GDN,
    Conv,
    ConvStack5,
    Deconv,
    SubpelConv,
    WinNoShiftAttention,
)
from progressivecodec_tpu_torch.ops.math import ste_round
from progressivecodec_tpu_torch.utils.profiling import span


class AnalysisTransform(nn.Sequential):
    """g_a: 4x (conv5 s2 [+ GDN]) with two windowed-attention blocks."""

    def __init__(self, N: int = 192, M: int = 320, cin: int = 3, device=None):
        super().__init__(
            Conv(cin, N, 5, 2, device=device),
            GDN(N, device=device),
            Conv(N, N, 5, 2, device=device),
            GDN(N, device=device),
            WinNoShiftAttention(N, 8, 8, 4, device=device),
            Conv(N, N, 5, 2, device=device),
            GDN(N, device=device),
            Conv(N, M, 5, 2, device=device),
            WinNoShiftAttention(M, 8, 4, 2, device=device),
        )


class SynthesisTransform(nn.Sequential):
    """g_s: mirror of g_a with inverse GDN and deconvs."""

    def __init__(self, N: int = 192, M: int = 320, out: int = 3, device=None):
        super().__init__(
            WinNoShiftAttention(M, 8, 4, 2, device=device),
            Deconv(M, N, 5, 2, device=device),
            GDN(N, inverse=True, device=device),
            Deconv(N, N, 5, 2, device=device),
            GDN(N, inverse=True, device=device),
            WinNoShiftAttention(N, 8, 8, 4, device=device),
            Deconv(N, N, 5, 2, device=device),
            GDN(N, inverse=True, device=device),
            Deconv(N, out, 5, 2, device=device),
        )


class HyperAnalysis(nn.Sequential):
    """h_a: conv3x3 stack, the third and the fifth stride 2, GELU between;
    `widths` are the four hidden widths (WACNN's and the progressive
    model's by default)."""

    def __init__(self, cin: int, N: int = 192, widths: Sequence[int] = (320, 288, 256, 224),
                 device=None):
        w0, w1, w2, w3 = widths
        super().__init__(
            Conv(cin, w0, 3, 1, device=device), nn.GELU(),
            Conv(w0, w1, 3, 1, device=device), nn.GELU(),
            Conv(w1, w2, 3, 2, device=device), nn.GELU(),
            Conv(w2, w3, 3, 1, device=device), nn.GELU(),
            Conv(w3, N, 3, 2, device=device),
        )


class HyperSynthesis(nn.Sequential):
    """h_mean_s / h_scale_s: conv + subpel upsampling stack; `widths` are
    the four hidden widths."""

    def __init__(self, cin: int, out: int = 320, widths: Sequence[int] = (192, 224, 256, 288),
                 device=None):
        w0, w1, w2, w3 = widths
        super().__init__(
            Conv(cin, w0, 3, 1, device=device), nn.GELU(),
            SubpelConv(w0, w1, 2, device=device), nn.GELU(),
            Conv(w1, w2, 3, 1, device=device), nn.GELU(),
            SubpelConv(w2, w3, 2, device=device), nn.GELU(),
            Conv(w3, out, 3, 1, device=device),
        )


class SliceTransforms(nn.ModuleList):
    """A bank of per-slice ConvStack5 parameter predictors; slice i takes
    `cins[i]` input channels."""

    def __init__(self, cins, out: int = 32, device=None):
        super().__init__([ConvStack5(c, out, device=device) for c in cins])


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ChARMFragments:
    """The hyperprior and ChARM base-slice codec fragments, channel-last in
    and out as in JAX, NCHW inside; every fragment converts its inputs to
    contiguous NCHW first, so the encode and the decode side run the same
    kernels on the same layouts.

    The model provides h_a, `_hyper_params`, the banks cc_mean_transforms,
    cc_scale_transforms and lrp_transforms, and `_base_width`: the hyper
    channels a base slice sees (d0 for the progressive model, M for WACNN
    and STF)."""

    def _base_slice(self, i: int, lm, ls, support: list):
        """NCHW base-slice parameter prediction -> (mu, scale, mean_support)."""
        d0 = self._base_width
        support = support[: min(i, self.cfg.max_support_slices)]
        mean_support = torch.cat([lm[:, :d0]] + support, dim=1)
        scale_support = torch.cat([ls[:, :d0]] + support, dim=1)
        mu = self.cc_mean_transforms[i](mean_support)
        scale = self.cc_scale_transforms[i](scale_support)
        return mu, scale, mean_support

    def _base_lrp(self, i: int, mean_support, y_hat_slice):
        lrp_support = torch.cat([mean_support, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(self.lrp_transforms[i](lrp_support))

    def _forward_base(self, y, n_split: int, n_base: int, training: bool = False, noise=None):
        """Forward of the hyperprior and the first `n_base` ChARM slices of y
        (B, h, w, C) split into `n_split`: rounding around the medians and
        the means (straight through in training), then the likelihoods, of
        the noisy latents in training, drawn from `noise` z first.
        Channel-last -> (lm, ls, z_lik, y_slices, y_hat, y_lik, mu, scale);
        the last four are lists over the base slices."""
        rnd = ste_round if training else torch.round
        z = self.h_a(nchw(y))
        _, z_lik = self.entropy_bottleneck(nhwc(z), training=training, noise=noise)
        med = self.entropy_bottleneck.medians().reshape(1, -1, 1, 1)
        lm, ls = self._hyper_params(rnd(z - med) + med)
        y_slices = torch.split(y, y.shape[-1] // n_split, dim=-1)
        y_hat, y_lik, mus, scales = [], [], [], []
        for i in range(n_base):
            mu, scale, ms = self._base_slice(i, lm, ls, y_hat)
            mu_l, scale_l = nhwc(mu), nhwc(scale)
            # channel-last, where the training noise is drawn as JAX draws it
            y_lik.append(gaussian_forward(y_slices[i], scale_l, mu_l,
                                          training=training, noise=noise)[1])
            y_hat_slice = rnd(nchw(y_slices[i]) - mu) + mu
            y_hat.append(y_hat_slice + self._base_lrp(i, ms, y_hat_slice))
            mus.append(mu_l)
            scales.append(scale_l)
        return (nhwc(lm), nhwc(ls), z_lik, y_slices, [nhwc(t) for t in y_hat], y_lik,
                mus, scales)

    @span("frag:codec_hyper_enc")
    def codec_hyper_enc(self, y):
        return nhwc(self.h_a(nchw(y)))

    @span("frag:codec_hyper_dec")
    def codec_hyper_dec(self, z_hat):
        lm, ls = self._hyper_params(nchw(z_hat))
        return nhwc(lm), nhwc(ls)

    @span("frag:codec_base_params")
    def codec_base_params(self, i: int, lm, ls, support, scale_table):
        mu, scale, ms = self._base_slice(i, nchw(lm), nchw(ls), [nchw(s) for s in support])
        mu, scale, ms = nhwc(mu), nhwc(scale), nhwc(ms)
        return mu, scale, build_indexes(scale, scale_table, 0.11), ms

    @span("frag:codec_base_recon")
    def codec_base_recon(self, i: int, ms, mu, vals):
        y0 = vals.reshape(mu.shape).to(torch.float32) + mu
        return y0 + nhwc(self._base_lrp(i, nchw(ms), nchw(y0)))

    @span("frag:codec_base_step")
    def codec_base_step(self, j: int, include_prev: bool, lm, ls, support,
                        scale_table, ms_prev, mu_prev, vals_prev):
        """Recon of base slice j-1 + params of slice j; include_prev is True
        iff slice j-1 lies inside slice j's support window."""
        y_prev = self.codec_base_recon(j - 1, ms_prev, mu_prev, vals_prev)
        sup = list(support) + ([y_prev] if include_prev else [])
        mu, scale, idx, ms = self.codec_base_params(j, lm, ls, sup, scale_table)
        return y_prev, mu, scale, idx, ms
