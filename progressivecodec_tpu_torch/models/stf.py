"""STF, the SymmetricalTransFormer (registry name "stf").

Zou, Song and Zhang, "The Devil Is in the Details: Window-based Attention
for Image Compression", CVPR 2022; github.com/Googolxx/STF,
`compressai/models/stf.py`.  WACNN's transformer sibling: a Swin analysis
(patch embedding, four stages of shifted-window blocks with patch merging)
and its mirror as the synthesis (patch splitting, then `end_conv`), with
the hyperprior, ChARM slice recursion and entropy models of WACNN
(`SingleRateFragments`), so `GranularCodec` codes it on WACNN's
non-progressive path: z, then all M // dim_chunk base slices.

Every size follows from `ModelConfig`'s N and M (`stf_sizes`): embed_dim
M // 8, stage widths embed_dim * 2^i, heads max(1, width // 16), the
published depths (2, 2, 6, 2), window 4, MLP ratio 4 and patch 2, and the
hyper widths N + k (M - N) / 4.  At N 192, M 384 these are STF's: widths
48-96-192-384, heads 3-6-12-24, h_a 384-336-288-240-192, h_s 240-288-336-384.

State-dict names follow STF's module tree: `patch_embed.*`,
`layers.<i>.blocks.<j>.*`, `layers.<i>.downsample.*`, `syn_layers.*`,
`end_conv.*`, `h_a.*`, `h_mean_s.*`, `h_scale_s.*`, `cc_mean_transforms.*`,
`cc_scale_transforms.*`, `lrp_transforms.*`, `entropy_bottleneck.*`.  The
port recomputes, instead of storing, every block's
`attn.relative_position_index` (`models/weights.py` drops it from an STF
checkpoint, as it drops CompressAI's entropy-model buffers).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.layers.blocks import Conv
from progressivecodec_tpu_torch.layers.swin import PatchEmbed, PatchMerging, PatchSplit, SwinStage
from progressivecodec_tpu_torch.models.transforms import (
    HyperAnalysis,
    HyperSynthesis,
    SliceTransforms,
    nchw,
    nhwc,
)
from progressivecodec_tpu_torch.models.wacnn import SingleRateFragments
from progressivecodec_tpu_torch.utils.profiling import span

DEPTHS = (2, 2, 6, 2)
WINDOW = 4
MLP_RATIO = 4.0
PATCH = 2
HEAD_DIM = 16


def stf_sizes(cfg: ModelConfig) -> dict:
    """STF's sizes from N and M, under the configuration file's "swin" keys,
    with the hyper widths under "hyper" (h_a's four hidden widths; h_s takes
    them reversed)."""
    n, m = cfg.N, cfg.M
    if m % 8 or (m - n) % 4:
        raise ValueError(f"STF needs M divisible by 8 and M - N by 4, not N={n}, M={m}")
    embed = m // 8
    widths = [embed * 2**i for i in range(len(DEPTHS))]
    heads = [max(1, w // HEAD_DIM) for w in widths]
    if any(w % h for w, h in zip(widths, heads)):
        raise ValueError(f"stage widths {widths} do not split into {heads} heads")
    return {"embed_dim": embed, "patch_size": PATCH, "depths": list(DEPTHS), "num_heads": heads,
            "window_size": WINDOW, "mlp_ratio": MLP_RATIO, "qkv_bias": True, "patch_norm": True,
            "hyper": [n + k * (m - n) // 4 for k in (4, 3, 2, 1)]}


class SymmetricalTransFormer(SingleRateFragments, nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        s = stf_sizes(cfg)
        n, m, dc = cfg.N, cfg.M, cfg.dim_chunk
        e, heads, depth = s["embed_dim"], s["num_heads"], len(DEPTHS)
        self.embed_dim = e
        self.num_slices = m // dc
        self._base_width = m
        self.patch_embed = PatchEmbed(PATCH, 3, e, device=device)
        self.layers = nn.ModuleList([
            SwinStage(e * 2**i, DEPTHS[i], heads[i], WINDOW, MLP_RATIO,
                      PatchMerging if i < depth - 1 else None, device=device)
            for i in range(depth)
        ])
        self.syn_layers = nn.ModuleList([
            SwinStage(e * 2 ** (depth - 1 - i), DEPTHS[depth - 1 - i], heads[depth - 1 - i], WINDOW,
                      MLP_RATIO, PatchSplit if i < depth - 1 else None, device=device)
            for i in range(depth)
        ])
        self.end_conv = nn.Sequential(Conv(e, e * PATCH**2, 5, 1, device=device), nn.PixelShuffle(PATCH),
                                      Conv(e, 3, 3, 1, device=device))
        self.h_a = HyperAnalysis(m, n, s["hyper"], device=device)
        self.h_mean_s = HyperSynthesis(n, m, s["hyper"][::-1], device=device)
        self.h_scale_s = HyperSynthesis(n, m, s["hyper"][::-1], device=device)
        cins = [m + dc * min(i, cfg.max_support_slices) for i in range(self.num_slices)]
        self.cc_mean_transforms = SliceTransforms(cins, dc, device=device)
        self.cc_scale_transforms = SliceTransforms(cins, dc, device=device)
        self.lrp_transforms = SliceTransforms([c + dc for c in cins], dc, device=device)
        self.entropy_bottleneck = EntropyBottleneck(n, device=device)

    @span("frag:analyze")
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> y (B, H/16, W/16, M), each stage's side rounded up."""
        t, h, w = self.patch_embed(nchw(x))
        for layer in self.layers:
            t, h, w = layer(t, h, w)
        return t.reshape(t.shape[0], h, w, -1)

    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """y_hat (B, h, w, M) -> x_hat (B, 16h, 16w, 3), not clipped."""
        b, h, w, c = y_hat.shape
        t = y_hat.reshape(b, h * w, c)
        for layer in self.syn_layers:
            t, h, w = layer(t, h, w)
        return self._end(t, h, w)

    @span("swin:end")
    def _end(self, t, h: int, w: int):
        """end_conv: conv5x5 (C -> 4C), pixel shuffle, conv3x3 (C -> 3)."""
        return nhwc(self.end_conv(t.reshape(t.shape[0], h, w, self.embed_dim).permute(0, 3, 1, 2).contiguous()))
