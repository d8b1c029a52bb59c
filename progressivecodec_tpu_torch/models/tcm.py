"""TCM, the mixed Transformer-CNN codec (registry name "tcm").

Liu, Sun and Katto, "Learned Image Compression with Mixed Transformer-CNN
Architectures", CVPR 2023; github.com/jmliu206/LIC_TCM, `models/tcm.py`,
class `TCM`.  g_a and g_s are stages of ConvTransBlocks (a CNN half and a
Swin half side by side, `layers/tcm.py`) between CompressAI's residual
blocks with stride or upsampling; the hyperprior is built the same way, in
windows of 4, with a z of 192 channels; each of the five ChARM slices puts
its mean and its scale support through a SWAtten before the slice's
networks, and its LRP reads the attended mean support.  `GranularCodec`
codes it on WACNN's and STF's single-rate path (`SingleRateFragments`): z,
then the M // dim_chunk slices.

TCM's constants live here; `ModelConfig` gives N (each half of a block; 2N
channels in the blocks), M, dim_chunk (M / 5 for TCM's five slices) and
max_support_slices.  At N 128, M 320, dim_chunk 64, max_support_slices 5
these are the published sizes (the constructor's defaults: the paper's large
model).  The configuration file's "tcm" entry is checked against them by the
plain reference (`benchmark/reference/tcm.py`).

Images must have sides that are multiples of 128 (the hyperprior's windows
of 4 at 1/32, SWAtten's windows of 8 at 1/16) and of at least 256: TCM's
SwinBlock pads a latent no larger than one window, a branch the port leaves
out, so it refuses such images.

State-dict names follow TCM's module tree: `g_a.*`, `g_s.*`, `h_a.*`,
`h_mean_s.*`, `h_scale_s.*`, `atten_mean.<i>.0.*`, `atten_scale.<i>.0.*`,
`cc_mean_transforms.*`, `cc_scale_transforms.*`, `lrp_transforms.*`,
`entropy_bottleneck.*`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.layers.blocks import Conv, ConvStack5, SubpelConv
from progressivecodec_tpu_torch.layers.tcm import (
    SWAtten,
    ConvTransBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelOut,
)
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc
from progressivecodec_tpu_torch.models.wacnn import SingleRateFragments
from progressivecodec_tpu_torch.utils.profiling import span

DEPTHS = (2, 2, 2, 2, 2, 2)  # TCM's `config`: CTBs per stage, g_a's three then g_s's
HEAD_DIM = (8, 16, 32, 32, 16, 8)
WINDOW = 8
HYPER_WINDOW = 4
HYPER_HEAD_DIM = 32
ATTEN_DIM = 128  # SWAtten's inter_dim
ATTEN_HEAD_DIM = 16
Z_CHANNELS = 192
SLICE_WIDTHS = (224, 128)  # the slice networks' hidden widths
SIDE = 128  # image sides: multiples of this, and at least two of them


def check_image(h: int, w: int) -> None:
    if h % SIDE or w % SIDE or min(h, w) < 2 * SIDE:
        raise ValueError(
            f"TCM codes images whose sides are multiples of {SIDE} and at least {2 * SIDE}, not "
            f"{h}x{w}: the windows of its hyperprior and SWAtten must tile the maps, and TCM pads "
            "a latent no larger than one window by a rule the port does not model"
        )


class TCM(SingleRateFragments, nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        n, m, dc = cfg.N, cfg.M, cfg.dim_chunk
        if m % dc or any(n % h for h in HEAD_DIM + (HYPER_HEAD_DIM,)):
            raise ValueError(f"TCM needs M divisible by dim_chunk and N by every head width, "
                             f"not N={n}, M={m}, dim_chunk={dc}")
        d = 2 * n
        self.num_slices = m // dc

        def blocks(s, window=WINDOW, head_dim=None):
            """Stage s's ConvTransBlocks, plain and shifted windows in turn."""
            hd = head_dim or HEAD_DIM[s]
            return [ConvTransBlock(n, hd, window, j % 2 == 1, device=device) for j in range(DEPTHS[s])]

        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, d, device=device), *blocks(0),
            ResidualBlockWithStride(d, d, device=device), *blocks(1),
            ResidualBlockWithStride(d, d, device=device), *blocks(2),
            Conv(d, m, 3, 2, device=device),
        )
        self.g_s = nn.Sequential(
            ResidualBlockUpsample(m, d, device=device), *blocks(3),
            ResidualBlockUpsample(d, d, device=device), *blocks(4),
            ResidualBlockUpsample(d, d, device=device), *blocks(5),
            SubpelOut(d, 3, 2, device=device),
        )
        self.h_a = nn.Sequential(ResidualBlockWithStride(m, d, device=device),
                                 *blocks(0, HYPER_WINDOW, HYPER_HEAD_DIM), Conv(d, Z_CHANNELS, 3, 2, device=device))
        self.h_mean_s = nn.Sequential(ResidualBlockUpsample(Z_CHANNELS, d, device=device),
                                      *blocks(3, HYPER_WINDOW, HYPER_HEAD_DIM), SubpelConv(d, m, 2, device=device))
        self.h_scale_s = nn.Sequential(ResidualBlockUpsample(Z_CHANNELS, d, device=device),
                                       *blocks(3, HYPER_WINDOW, HYPER_HEAD_DIM), SubpelConv(d, m, 2, device=device))
        cins = [m + dc * min(i, cfg.max_support_slices) for i in range(self.num_slices)]
        for bank, name in (("atten_mean", "swatten:mean"), ("atten_scale", "swatten:scale")):
            setattr(self, bank, nn.ModuleList([
                nn.Sequential(SWAtten(c, ATTEN_DIM, ATTEN_HEAD_DIM, WINDOW, name, device=device))
                for c in cins]))
        self.cc_mean_transforms = nn.ModuleList([ConvStack5(c, dc, SLICE_WIDTHS, device=device) for c in cins])
        self.cc_scale_transforms = nn.ModuleList([ConvStack5(c, dc, SLICE_WIDTHS, device=device) for c in cins])
        self.lrp_transforms = nn.ModuleList([ConvStack5(c + dc, dc, SLICE_WIDTHS, device=device) for c in cins])
        self.entropy_bottleneck = EntropyBottleneck(Z_CHANNELS, device=device)

    @span("frag:analyze")
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> y (B, H/16, W/16, M)."""
        check_image(x.shape[1], x.shape[2])
        return nhwc(self.g_a(nchw(x)))

    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """y_hat (B, h, w, M) -> x_hat (B, 16h, 16w, 3), not clipped."""
        return nhwc(self.g_s(nchw(y_hat)))

    def _base_slice(self, i: int, lm, ls, support: list):
        """Slice i's mean and scale, each from its support attended by the
        slice's SWAtten; the LRP reads the attended mean support."""
        support = support[: min(i, self.cfg.max_support_slices)]
        mean_support = self.atten_mean[i](torch.cat([lm] + support, dim=1))
        mu = self.cc_mean_transforms[i](mean_support)
        scale = self.cc_scale_transforms[i](self.atten_scale[i](torch.cat([ls] + support, dim=1)))
        return mu, scale, mean_support
