"""WACNN, the single-rate window-attention codec (registry name "cnn").

Counterpart of `progressivecodec_tpu/models/wacnn.py`: the same transforms
and ChARM slice recursion as the progressive model's base layer, over all
M // dim_chunk slices of an M-channel latent, with one synthesis, and the
forward with the likelihoods, noise-quantised in training.  Module names
follow the reference's tree, so its state dict loads with `strict=True`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.models.transforms import (
    AnalysisTransform,
    ChARMFragments,
    HyperAnalysis,
    HyperSynthesis,
    SliceTransforms,
    SynthesisTransform,
    nchw,
    nhwc,
)


class WACNN(ChARMFragments, nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        n, m, dc = cfg.N, cfg.M, cfg.dim_chunk
        self.num_slices = m // dc
        self._base_width = m
        self.g_a = AnalysisTransform(n, m, device=device)
        self.g_s = SynthesisTransform(n, m, device=device)
        self.h_a = HyperAnalysis(m, n, device=device)
        self.h_mean_s = HyperSynthesis(n, m, device=device)
        self.h_scale_s = HyperSynthesis(n, m, device=device)
        cins = [m + dc * min(i, cfg.max_support_slices) for i in range(self.num_slices)]
        self.cc_mean_transforms = SliceTransforms(cins, dc, device=device)
        self.cc_scale_transforms = SliceTransforms(cins, dc, device=device)
        self.lrp_transforms = SliceTransforms([c + dc for c in cins], dc, device=device)
        self.entropy_bottleneck = EntropyBottleneck(n, device=device)

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> y (B, H/16, W/16, M)."""
        return nhwc(self.g_a(nchw(x)))

    def _hyper_params(self, z_hat: torch.Tensor):
        return self.h_mean_s(z_hat), self.h_scale_s(z_hat)

    def forward(self, x, *, training: bool = False, noise=None) -> dict:
        """x (B, H, W, 3) -> {"x_hat", "likelihoods": {"y", "z"}, "y_hat"},
        channel-last, latents rounded around their means (straight through
        in training); x_hat is not clipped.  In training the likelihoods
        are of the noisy latents, drawn from `noise`: z, then each slice
        (JAX splits 2 + num_slices keys and never draws from its key 1)."""
        if training and noise is None:
            raise ValueError("the training forward needs a noise source")
        _, _, z_lik, _, y_hat, y_lik, _, _ = self._forward_base(
            self.analyze(x), self.num_slices, self.num_slices, training=training, noise=noise
        )
        y_hat = torch.cat(y_hat, dim=-1)
        return {"x_hat": nhwc(self.g_s(nchw(y_hat))),
                "likelihoods": {"y": torch.cat(y_lik, dim=-1), "z": z_lik}, "y_hat": y_hat}

    def forward_single_quality(self, x, quality: float = 0.0, mask_pol=None, *,
                               training: bool = False, noise=None) -> dict:
        """The forward with x_hat clipped to [0, 1]; a single-rate model,
        so the quality is ignored."""
        out = self.forward(x, training=training, noise=noise)
        out["x_hat"] = torch.clamp(out["x_hat"], 0.0, 1.0)
        return out

    def codec_synth(self, which: int, y_hat):
        """One synthesis whatever `which` asks."""
        return nhwc(torch.clamp(self.g_s(nchw(y_hat)), 0.0, 1.0))
