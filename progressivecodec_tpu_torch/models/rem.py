"""REM, the rate-enhancement model (registry name "rate").

Counterpart of `progressivecodec_tpu/models/rem.py`.  The progressive model
plus one LatentRateReduction bank per (checkpoint interval, base slice):
between the checkpoint qualities `cfg.check_levels` (default 0.01, 0.25,
1.75) a bank refines the predicted sigma of an enhancement slice, gated by
the attention mask mask(q) - mask(q_bar), where q_bar is the checkpoint
below q.  It overrides the progressive model's `_refine_prog_params` hook
(and `_refine_units`, its banks as CUDA-graph units of `models/graphs.py`:
the attention mask stays eager, each bank is a graph in the codec's loop),
so the forwards and the codec fragments are inherited; the model is
always unrolled (`uses_stacked_prog` is False for "rate").

The escalation cascade codes one stream per checkpoint below the target
quality, each anchored on the previous level's reconstructed latent, then
the target stream.  The anchor feeds the banks, which decide sigma, mask
and keep of the next level, so the encoder's and the decoder's anchors must
agree bit for bit: both come from the same codec fragments
(`compress_from_latent(simulate=True)` and `decompress_to_latent`) on the
same batch shape under `device.set_deterministic()`.

State-dict names are the reference's (`export_rem`): the base tree under
`base_net.` and the banks under `post_latent.{k}.{i}.`.  The module tree is
flat, as in JAX; `state_dict()` adds the `base_net.` prefix and
`load_state_dict()` strips it (`reference_name`), so reference-named and
flat state dicts both load with `strict=True`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.layers.blocks import Conv
from progressivecodec_tpu_torch.layers.masking import apply_mask_noise, channel_mask
from progressivecodec_tpu_torch.models import graphs
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc
from progressivecodec_tpu_torch.utils.profiling import span

BASE_PREFIX = "base_net."
BANKS = "post_latent."


class ResidualBlock(nn.Module):
    """conv3x3 -> LeakyReLU(0.01) -> conv3x3 -> LeakyReLU(0.01), plus the
    input, through a 1x1 `skip` where the widths differ (NCHW)."""

    def __init__(self, cin: int, out: int, device=None):
        super().__init__()
        self.conv1 = Conv(cin, out, 3, 1, device=device)
        self.conv2 = Conv(out, out, 3, 1, device=device)
        self.skip = Conv(cin, out, 1, 1, device=device) if cin != out else None

    def forward(self, x):
        y = F.leaky_relu(self.conv1(x), 0.01)
        y = F.leaky_relu(self.conv2(y), 0.01)
        return y + (x if self.skip is None else self.skip(x))


def _stack(cin: int, widths, device) -> nn.Sequential:
    blocks = []
    for w in widths:
        blocks.append(ResidualBlock(cin, w, device=device))
        cin = w
    return nn.Sequential(*blocks)


class LatentRateReduction(nn.Module):
    """Refines an enhancement slice's entropy parameters between
    checkpoints.  Inputs, channel-last: the anchor x_base (dc), params_base
    = [mu_b, scale_b] (2 dc), params_enh = scale (dc; [mu, scale] with
    mu_std) and the attention mask (as params_enh).  Returns params_enh +
    zero_out(enc(...)) * att; `zero_out` is zero at init, so the bank starts
    as the identity."""

    def __init__(self, dim_chunk: int = 32, mu_std: bool = False, dimension: str = "big",
                 device=None):
        super().__init__()
        n = dim_chunk
        deep = dimension == "big"
        base_w = [n] * (3 if deep else 2)
        out_w = 2 * n if mu_std else n
        self.enc_base_entropy_params = _stack(2 * n, base_w, device)
        self.enc_enh_entropy_params = _stack(out_w, base_w, device)
        self.enc_base_rep = _stack(n, base_w, device)
        self.enc = _stack(3 * n, [2 * n] * (3 if deep else 2) + [out_w], device)
        self.zero_out = nn.Linear(out_w, out_w, device=device, dtype=torch.float32)

    def forward(self, x_base, params_base, params_enh, att_mask):
        f_ent_prog = self.enc_enh_entropy_params(nchw(params_enh))
        f_latent = self.enc_base_rep(nchw(x_base))
        f_ent_base = self.enc_base_entropy_params(nchw(params_base))
        ret = nhwc(self.enc(torch.cat([f_latent, f_ent_base, f_ent_prog], dim=1)))
        return params_enh + self.zero_out(ret) * att_mask


def _f32(q: float) -> float:
    return float(np.float32(q))


def find_check_quality(quality: float, check_levels) -> tuple[float, float]:
    """(quality_ref, quality_post): the checkpoint interval holding quality.

    The comparisons are made at float32, the precision the container holds
    the quality in: a level float32 cannot hold (0.1) then still holds the
    container's value of itself, as the reference's encoder holds the
    float64 level.  The bounds are returned as given."""
    cl = list(check_levels)
    c, q = [_f32(v) for v in cl], _f32(quality)
    if q <= c[0]:
        return 0.0, 0.0
    if len(c) >= 2 and c[0] < q <= c[1]:
        return cl[0], cl[1]
    if len(c) == 2:
        return cl[1], 10.0
    if len(c) == 3 and c[1] < q <= c[2]:
        return cl[1], cl[2]
    return cl[-1], 10.0


def _interval_index(quality: float, check_levels) -> int:
    """Which level's banks refine at `quality` (compared at float32)."""
    c, q = [_f32(v) for v in check_levels], _f32(quality)
    if len(c) == 1:
        return 0
    if len(c) == 2:
        return 0 if c[0] < q <= c[1] else 1
    if c[0] < q <= c[1]:
        return 0
    if c[1] < q <= c[2]:
        return 1
    return 2


def reference_name(name: str) -> str:
    """Port parameter name -> the reference's: the base tree under base_net."""
    return name if name.startswith(BANKS) else BASE_PREFIX + name


class PostRateProcessedNetwork(ChannelProgressiveWACNN):
    """The progressive model plus LatentRateReduction banks: `post_latent[k][i]`
    for checkpoint interval k and slice i (ns0 per interval, as JAX builds
    them)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(name="rate"), device=None,
                 mu_std: bool = False, dimension: str = "big"):
        super().__init__(cfg, device=device)
        device = resolve_device(device)
        self.mu_std = mu_std
        self.post_latent = nn.ModuleList([
            nn.ModuleList([LatentRateReduction(cfg.dim_chunk, mu_std, dimension, device=device)
                           for _ in range(cfg.ns0)])
            for _ in cfg.check_levels
        ])
        self.register_state_dict_post_hook(_to_reference_names)
        self.register_load_state_dict_pre_hook(_from_reference_names)

    @staticmethod
    def init_qualities(cfg: ModelConfig) -> list:
        """One quality inside each checkpoint interval, after the base."""
        bounds = list(cfg.check_levels) + [10.0]
        return [0.0] + [(a + b) / 2 for a, b in zip(bounds, bounds[1:])]

    @span("rem:refine")
    def _refine_prog_params(self, i, quality, mu, scale, mu_b, scale_b, y_b_hat, mask_pol,
                            training: bool = False):
        cfg = self.cfg
        if _f32(quality) <= _f32(cfg.check_levels[0]):
            return mu, scale
        q_bar, _ = find_check_quality(quality, cfg.check_levels)
        mk = dict(mask_pol=mask_pol or "point-based-std", slice_index=i,
                  dim_chunk=cfg.dim_chunk, division_channel=cfg.division_channel)
        # the attention mask ranks the unrefined sigma; straight through in training
        att = apply_mask_noise(channel_mask(scale, pr=quality, **mk)
                               - channel_mask(scale, pr=q_bar, **mk), training)
        k = _interval_index(quality, cfg.check_levels)
        out = graphs.units().run(("bank", k, i), self._bank, k, i, mu, scale, mu_b, scale_b,
                                 y_b_hat, att)
        if self.mu_std:
            return torch.chunk(out, 2, dim=-1)
        return mu, out

    def _bank(self, k, i, mu, scale, mu_b, scale_b, y_b_hat, att):
        """Bank k of slice i on the attention mask att: the refined scale, or
        [mu, scale] with mu_std."""
        if self.mu_std:
            att = torch.cat([att, att], dim=-1)
        params_base = torch.cat([mu_b, scale_b], dim=-1)
        params_enh = torch.cat([mu, scale], dim=-1) if self.mu_std else scale
        return self.post_latent[k][i](y_b_hat, params_base, params_enh, att)

    def _refine_units(self, i, mu, scale, mu_b, scale_b, y_b_hat) -> list:
        """Slice i's bank of every checkpoint interval, on a placeholder
        attention mask."""
        att = torch.zeros_like(scale)
        return [(("bank", k, i), self._bank, (k, i, mu, scale, mu_b, scale_b, y_b_hat, att))
                for k in range(len(self.post_latent))]


def _to_reference_names(module, state_dict, prefix, local_metadata) -> None:
    items = list(state_dict.items())
    state_dict.clear()
    for k, v in items:
        if k.startswith(prefix):
            k = prefix + reference_name(k[len(prefix):])
        state_dict[k] = v


def _from_reference_names(module, state_dict, prefix, local_metadata, strict, missing_keys,
                          unexpected_keys, error_msgs) -> None:
    for k in [k for k in state_dict if k.startswith(prefix + BASE_PREFIX)]:
        state_dict[prefix + k[len(prefix + BASE_PREFIX):]] = state_dict.pop(k)


@torch.no_grad()
def escalation_compress(codec, x, quality: float, mask_pol: str | None = None) -> dict:
    """Cascaded encode: one container per checkpoint level below `quality`,
    each anchored on the previous level's reconstructed latent, then the
    target container.  The analysis runs once.  Returns {"checkpoints":
    [container, ...], "final": container, "anchors": [latent, ...]};
    "final" keeps the encoder's simulated "x_hat" and "y_hat", and "anchors"
    holds the latent each level after the first was coded on."""
    cl = [q for q in codec.cfg.check_levels if _f32(q) < _f32(quality)]
    codec.update()
    x = codec._as_input(x)
    y = codec.model.analyze(x)
    rep = None
    checkpoints, anchors = [], []
    for q in cl:
        d = codec.compress_from_latent(y, tuple(x.shape), quality=float(q), mask_pol=mask_pol,
                                       checkpoint_rep=rep, simulate=True)
        rep = d.pop("y_hat")
        d.pop("x_hat")
        checkpoints.append(d)
        anchors.append(rep)
    final = codec.compress_from_latent(y, tuple(x.shape), quality=float(quality),
                                       mask_pol=mask_pol, checkpoint_rep=rep, simulate=True)
    return {"checkpoints": checkpoints, "final": final, "anchors": anchors}


@torch.no_grad()
def escalation_decompress(codec, data: dict) -> dict:
    """Decoder side of the cascade: each checkpoint container decoded on the
    previous level's latent, then the final one -> {"x_hat", "stream_ok",
    "y_hat", "anchors"} (anchors: the latents each level was decoded on)."""
    rep = None
    ok = True
    anchors = []
    for d in data["checkpoints"]:
        out = codec.decompress_to_latent(d, checkpoint_rep=rep)
        ok = ok and bool(out["stream_ok"])
        rep = out["y_hat"]
        anchors.append(rep)
    out = codec.decompress(data["final"], checkpoint_rep=rep)
    return {"x_hat": out["x_hat"], "stream_ok": ok and bool(out["stream_ok"]),
            "y_hat": out["y_hat"], "anchors": anchors}


@torch.no_grad()
def extract_checkpoint_representation(model, x, mask_pol: str = "point-based-std"):
    """The eval forward's cascade: at each checkpoint quality in turn, anchored
    on the previous level's y_hat.  Returns the last level's y_hat."""
    rep = None
    for q in model.cfg.check_levels:
        rep = model.forward_single_quality(x, float(q), mask_pol, checkpoint_rep=rep)["y_hat"]
    return rep
