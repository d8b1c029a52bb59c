"""ChannelProgressiveWACNN, the channel-progressive codec.

Counterpart of `progressivecodec_tpu/models/progressive.py`.  The M-channel
latent is split at `division_dimension`: slices 0..ns0-1 form the base
layer, coded with the ChARM recursion; the enhancement slices are masked
element-wise by the rank of their predicted sigma (or by a learnable conv
importance map).

Two enhancement paths, as in JAX:
  * stacked (`uses_stacked_prog`, the flagship `ModelConfig()` among
    them): the enhancement slices are mutually independent and one bank
    codes them together (a plain loop over its slices where JAX vmaps);
  * unrolled: slice by slice, each conditioned on its co-located base
    slice and on up to `support_progressive_slices` earlier enhancement
    slices (or their means and scales, `all_scalable`), joined into the
    base by a residual or a joiner net, masked by sigma or a learnable map.

`forward` is the multi-quality training forward (JAX's `__call__`):
noise-quantised likelihoods, the noise drawn from an explicit source
(`ops/noise.py`) in JAX's order, and straight-through rounding.
`forward_single_quality` is the forward at one quality, with the
likelihoods (eval, or training with noise).  `_refine_prog_params` is the
hook REM (`models/rem.py`) overrides, with `_refine_units`; `checkpoint_rep`
anchors it in place of the base slices.  The unrolled fragments
(`codec_prog_params`, `codec_prog_recon`) run their quality-independent
networks as units of `models/graphs.py`: CUDA graphs inside the codec's
loop on the card, plain calls everywhere else.

Internals are NCHW `nn.Module`s.  The public methods (`analyze`,
`forward_single_quality` and the `codec_*` fragments the granular codec
calls) take and return channel-last tensors, like the JAX package
(`transforms.ChARMFragments`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.device import resolve_device
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.entropy.gaussian import build_indexes, gaussian_forward
from progressivecodec_tpu_torch.layers.blocks import Conv
from progressivecodec_tpu_torch.layers.masking import (
    apply_mask_noise,
    channel_mask,
    stacked_channel_mask,
)
from progressivecodec_tpu_torch.layers.masking_learnable import LearnableMaskStack
from progressivecodec_tpu_torch.layers.unet import refine_net
from progressivecodec_tpu_torch.models import graphs
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
from progressivecodec_tpu_torch.ops.math import ste_round
from progressivecodec_tpu_torch.utils.profiling import span


def uses_stacked_prog(cfg: ModelConfig) -> bool:
    """Mirror of the JAX `_use_stacked_prog`: enhancement slices are
    independent, so one bank codes them together.  REM refines slices one
    by one and keeps the unrolled path."""
    return (
        cfg.stack_prog
        and cfg.support_progressive_slices == 0
        and not cfg.all_scalable
        and cfg.joiner_policy == "res"
        and "learnable" not in cfg.mask_policy
        and cfg.name != "rate"
    )


def unstack_channels(x_stack: torch.Tensor) -> torch.Tensor:
    """(S, B, h, w, dc) -> (B, h, w, S*dc), slice-major channels."""
    s_, b, h, w, dc = x_stack.shape
    return x_stack.permute(1, 2, 3, 0, 4).reshape(b, h, w, s_ * dc)


class JoinerStack(nn.Sequential):
    """conv3(64)-GELU-conv3(64)-GELU-conv3(out) merge of (enhancement, base)."""

    def __init__(self, cin: int, out: int, device=None):
        super().__init__(
            Conv(cin, 64, 3, 1, device=device), nn.GELU(),
            Conv(64, 64, 3, 1, device=device), nn.GELU(),
            Conv(64, out, 3, 1, device=device),
        )


class LearnableMasking(nn.Module):
    """Holder named like the reference's `masking` module (`masking.mask_conv.i`)."""

    def __init__(self, n: int, cin: int, out: int, device=None):
        super().__init__()
        self.mask_conv = nn.ModuleList([LearnableMaskStack(cin, out, device=device) for _ in range(n)])


class ChannelProgressiveWACNN(ChARMFragments, nn.Module):
    """Module tree named like the reference (`g_a.0.…`, `cc_mean_transforms.3.…`),
    so a reference-named state dict loads with `strict=True`."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None):
        super().__init__()
        self.stacked = uses_stacked_prog(cfg)
        if self.stacked and cfg.ns0 != cfg.num_prog_slices:
            raise NotImplementedError("the stacked bank needs ns0 == num_prog_slices")
        device = resolve_device(device)
        self.cfg = cfg
        n, dc = cfg.N, cfg.dim_chunk
        d0, d1 = cfg.division_dimension
        self._base_width = d0
        if cfg.multiple_encoder:
            self.g_a = nn.ModuleList([AnalysisTransform(n, d0, device=device) for _ in range(2)])
            y_ch = 2 * d0
        else:
            self.g_a = AnalysisTransform(n, d1, device=device)
            y_ch = d1
        if cfg.multiple_decoder:
            self.g_s = nn.ModuleList([SynthesisTransform(n, d0, device=device) for _ in range(2)])
        else:
            self.g_s = SynthesisTransform(n, d0, device=device)
        self.h_a = HyperAnalysis(y_ch, n, device=device)
        if cfg.multiple_hyperprior:
            self.h_mean_s = nn.ModuleList([HyperSynthesis(n, d0, device=device) for _ in range(2)])
            self.h_scale_s = nn.ModuleList([HyperSynthesis(n, d0, device=device) for _ in range(2)])
            enh = d0  # channels of the hyper output past d0
        else:
            self.h_mean_s = HyperSynthesis(n, d1, device=device)
            self.h_scale_s = HyperSynthesis(n, d1, device=device)
            enh = d1 - d0
        base_in = [d0 + dc * min(i, cfg.max_support_slices) for i in range(cfg.ns0)]
        self.cc_mean_transforms = SliceTransforms(base_in, dc, device=device)
        self.cc_scale_transforms = SliceTransforms(base_in, dc, device=device)
        self.lrp_transforms = SliceTransforms([c + dc for c in base_in], dc, device=device)
        # enhancement slice i sees the hyper channels past d0, its base slice
        # and `_n_support(i)` earlier enhancement entries; the unrolled lrp
        # bank has ns0 entries, as the reference's
        prog_in = [enh + dc * (1 + self._n_support(i)) for i in range(cfg.num_prog_slices)]
        n_lrp = cfg.num_prog_slices if self.stacked else cfg.ns0
        self.cc_mean_transforms_prog = SliceTransforms(prog_in, dc, device=device)
        self.cc_scale_transforms_prog = SliceTransforms(prog_in, dc, device=device)
        self.lrp_transforms_prog = SliceTransforms(
            [enh + dc * (2 + self._n_support(i)) for i in range(n_lrp)], dc, device=device
        )
        self.entropy_bottleneck = EntropyBottleneck(n, device=device)
        if "learnable" in cfg.mask_policy:
            self.masking = LearnableMasking(
                cfg.num_prog_slices, 2 * dc if cfg.double_dim else dc, dc, device=device
            )
        if cfg.joiner_policy in ("cond", "channel_cond", "channel_res"):
            self.joiner = nn.ModuleList([JoinerStack(2 * dc, dc, device=device) for _ in range(cfg.ns0)])
        if cfg.u_net_post == 1:
            self.refine = refine_net(device)
        elif cfg.u_net_post == 2:
            self.refine = nn.ModuleList([refine_net(device) for _ in range(2)])

    def _n_support(self, i: int) -> int:
        """Earlier enhancement entries in slice i's support."""
        sps = self.cfg.support_progressive_slices
        return 0 if i == 0 or sps == 0 else min(sps, i)

    # ------------------------------------------------------------------
    # pieces (NCHW inside)
    # ------------------------------------------------------------------

    @span("frag:analyze")
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> y (B, H/16, W/16, C), base | enhancement channels."""
        x = nchw(x)
        if self.cfg.multiple_encoder:
            y = torch.cat([self.g_a[0](x), self.g_a[1](x)], dim=1)
        else:
            y = self.g_a(x)
        return nhwc(y)

    def _hyper_params(self, z_hat: torch.Tensor):
        """NCHW z_hat -> NCHW (latent_means, latent_scales)."""
        if not self.cfg.multiple_hyperprior:
            return self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        means = torch.cat([self.h_mean_s[0](z_hat), self.h_mean_s[1](z_hat)], dim=1)
        scales = torch.cat([self.h_scale_s[0](z_hat), self.h_scale_s[1](z_hat)], dim=1)
        return means, scales

    def _synth_net(self, which: int):
        return self.g_s[which] if self.cfg.multiple_decoder else self.g_s

    def _apply_refine(self, x_hat, which: int):
        u = self.cfg.u_net_post
        if u == 1:
            return self.refine(x_hat)
        if u == 2:
            return self.refine[min(which, 1)](x_hat)
        return x_hat

    def _merge(self, y_enh, y_base, i: int):
        """Join an enhancement slice into its base slice (NCHW)."""
        if self.cfg.joiner_policy == "res":
            return y_enh + y_base
        return self.joiner[i](torch.cat([y_enh, y_base], dim=1))

    def _support(self, y_hat_base: list, i: int, entries: list) -> list:
        """[co-located base slice] + the slice's earlier enhancement entries."""
        k = self._n_support(i)
        return [y_hat_base[i]] + entries[i - k : i] if k else [y_hat_base[i]]

    def _prog_params_stacked(self, lm, ls, y_hat_base: list):
        """NCHW -> (mu, scale, mean_support, base_stack) stacks, each (S, B, C, h, w)."""
        d0 = self.cfg.division_channel
        lm_e, ls_e = lm[:, d0:], ls[:, d0:]
        mu, scale, ms = [], [], []
        for i, base in enumerate(y_hat_base):
            mean_support = torch.cat([lm_e, base], dim=1)
            scale_support = torch.cat([ls_e, base], dim=1)
            mu.append(self.cc_mean_transforms_prog[i](mean_support))
            scale.append(self.cc_scale_transforms_prog[i](scale_support))
            ms.append(mean_support)
        return torch.stack(mu), torch.stack(scale), torch.stack(ms), torch.stack(y_hat_base)

    def _prog_slice(self, i, lm, ls, y_hat_base, mu_total, std_total, prog_slices):
        """NCHW unrolled enhancement-slice parameters -> (mu, scale, mut, mean_support)."""
        cfg = self.cfg
        d0 = cfg.division_channel
        sup_mean = self._support(y_hat_base, i, mu_total if cfg.all_scalable else prog_slices)
        sup_std = self._support(y_hat_base, i, std_total if cfg.all_scalable else prog_slices)
        mean_support = torch.cat([lm[:, d0:]] + sup_mean, dim=1)
        scale_support = torch.cat([ls[:, d0:]] + sup_std, dim=1)
        mu = self.cc_mean_transforms_prog[i](mean_support)
        scale = self.cc_scale_transforms_prog[i](scale_support)
        mut = mu + y_hat_base[i] if cfg.total_mu_rep else mu
        return mu, scale, mut, mean_support

    def _prog_slice_nhwc(self, i, lm, ls, y_hat_base, mu_total, std_total, prog_slices):
        """Channel-last `_prog_slice`."""
        mu, scale, mut, ms = self._prog_slice(
            i, nchw(lm), nchw(ls), *([nchw(t) for t in ts] for ts in
                                     (y_hat_base, mu_total, std_total, prog_slices))
        )
        return nhwc(mu), nhwc(scale), nhwc(mut), nhwc(ms)

    def _refine_prog_params(self, i, quality, mu, scale, mu_b, scale_b, y_b_hat, mask_pol,
                            training: bool = False):
        """Hook for REM-style (mu, scale) refinement of enhancement slices;
        the identity here."""
        return mu, scale

    def _refine_units(self, i, mu, scale, mu_b, scale_b, y_b_hat) -> list:
        """The hook's quality-independent networks for slice i, every one it
        may run at some quality, as (key, fn, args) units of
        `models/graphs.py`; none here."""
        return []

    def _hook_anchor(self, i: int, y_hat_base: list, checkpoint_rep):
        """The refinement hook's anchor for slice i: the slice's channels of
        a cascaded checkpoint representation when given, else its decoded
        base slice."""
        if checkpoint_rep is None:
            return y_hat_base[i]
        dc = self.cfg.dim_chunk
        return checkpoint_rep[..., i * dc : (i + 1) * dc]

    def _mask_for(self, scale, pr, mask_pol, i, y_base_slice, cust_map=None,
                  training: bool = False):
        """Channel-last mask of enhancement slice i: the learnable levels
        (pr 0 none, 2 all, else the conv importance map, rounded straight
        through in training) or a sigma policy of `layers/masking.py`."""
        cfg = self.cfg
        if mask_pol is not None and "learnable" in mask_pol:
            if pr == 0:
                return torch.zeros_like(scale)
            if pr == 2:
                return torch.ones_like(scale)
            inp = torch.cat([scale, y_base_slice], dim=-1) if cfg.double_dim else scale
            rnd = ste_round if training else torch.round
            return rnd(nhwc(self.masking.mask_conv[i](nchw(inp))))
        return channel_mask(
            scale, pr=pr, mask_pol=mask_pol, slice_index=i, dim_chunk=cfg.dim_chunk,
            division_channel=cfg.division_channel, cust_map=cust_map,
        )

    # ------------------------------------------------------------------
    # training forward: every quality of the ladder in one pass
    # ------------------------------------------------------------------

    def forward(self, x, quality=None, mask_pol=None, *, training: bool = True, noise=None,
                checkpoint_rep=None, cust_map=None) -> dict:
        """Multi-quality forward, JAX's `__call__`: x (B, H, W, 3) at the
        qualities `quality` (default 0..scalable_levels-1; 0 is put first
        when missing) -> {"x_hat" (L, B, H, W, 3), not clipped,
        "likelihoods": {"y" (base), "y_prog" (L-1, B, h, w, base + enh),
        "z"}, "y_base", "y_prog" (the last quality's enhancement)},
        channel-last.  In training the latents are noise-quantised for the
        likelihoods, with U(-0.5, 0.5) drawn from `noise` (`ops/noise.py`):
        z, the base slices, then per quality the stacked enhancement at once
        or its slices in turn; the reconstructions round straight through."""
        cfg = self.cfg
        mask_pol = mask_pol or cfg.mask_policy
        qualities = list(quality) if quality is not None else list(range(cfg.scalable_levels))
        if not qualities or qualities[0] != 0:
            qualities = [0] + qualities
        if training and noise is None:
            raise ValueError("the training forward needs a noise source")
        lm, ls, z_lik, y_slices, y_hat_base, y_lik_base, mu_base, std_base = self._forward_base(
            self.analyze(x), cfg.ns1, cfg.ns0, training=training, noise=noise
        )
        y_hat_b = torch.cat(y_hat_base, dim=-1)
        x_hats = [self._synthesize(0, y_hat_b)]
        y_lik_prog, y_hat_enh = [], y_hat_b
        for q in qualities[1:]:
            enh = self._enhancement(q, mask_pol, lm, ls, y_slices, y_hat_base, mu_base, std_base,
                                    training, noise, checkpoint_rep, cust_map,
                                    mask_ste=training and "learnable" in mask_pol)
            y_hat_enh = enh["y_hat"]
            x_hats.append(self._synthesize(1, y_hat_enh))
            # a quality's stream codes the base and the enhancement
            y_lik_prog.append(torch.cat(y_lik_base + [enh["lik"]], dim=-1)[None])
        y_lik_b = torch.cat(y_lik_base, dim=-1)
        return {"x_hat": torch.stack(x_hats),
                "likelihoods": {"y": y_lik_b,
                                "y_prog": torch.cat(y_lik_prog) if y_lik_prog
                                else torch.ones_like(y_lik_b),
                                "z": z_lik},
                "y_base": y_hat_b, "y_prog": y_hat_enh}

    # ------------------------------------------------------------------
    # single-quality forward
    # ------------------------------------------------------------------

    def forward_single_quality(self, x, quality: float, mask_pol=None, *, training: bool = False,
                               noise=None, checkpoint_rep=None, cust_map=None) -> dict:
        """Forward at one quality: x (B, H, W, 3) -> {"x_hat",
        "likelihoods": {"y", "z"}, "y_hat", "mu", "std"}, and at quality > 0
        also "mask", "mu_base" and "std_base" (mu and std are the
        enhancement's before refinement); channel-last, x_hat clipped to
        [0, 1].  Latents are rounded around their means; in training the
        likelihoods are of the noisy latents, each draw taken from `noise`
        in turn (JAX passes one key to every draw)."""
        if training and noise is None:
            raise ValueError("the training forward needs a noise source")
        cfg = self.cfg
        mask_pol = mask_pol or cfg.mask_policy
        lm, ls, z_lik, y_slices, y_hat_base, y_lik, mu_base, std_base = self._forward_base(
            self.analyze(x), cfg.ns1, cfg.ns0, training=training, noise=noise
        )
        cat = lambda ts: torch.cat(ts, dim=-1)  # noqa: E731
        if quality == 0:
            y_hat = cat(y_hat_base)
            return {"x_hat": self.codec_synth(0, y_hat),
                    "likelihoods": {"y": cat(y_lik), "z": z_lik},
                    "y_hat": y_hat, "mu": cat(mu_base), "std": cat(std_base)}
        enh = self._enhancement(quality, mask_pol, lm, ls, y_slices, y_hat_base, mu_base,
                                std_base, training, noise, checkpoint_rep, cust_map)
        return {"x_hat": self.codec_synth(1, enh["y_hat"]),
                "likelihoods": {"y": cat(y_lik + [enh["lik"]]), "z": z_lik},
                "y_hat": enh["y_hat"], "mu": enh["mu"], "std": enh["std"], "mask": enh["mask"],
                "mu_base": cat(mu_base), "std_base": cat(std_base)}

    def _enhancement(self, quality, mask_pol, lm, ls, y_slices, y_hat_base, mu_base, std_base,
                     training, noise, checkpoint_rep, cust_map, mask_ste=False) -> dict:
        """The enhancement layer at one quality > 0, channel-last -> {"y_hat"
        (merged into the base), "lik", "mu", "std" (before refinement),
        "mask"}.  `mask_ste` rounds the mask straight through."""
        cfg = self.cfg
        rnd = ste_round if training else torch.round
        y_prog = [y_slices[cfg.ns0 + i] - y_slices[i] if cfg.delta_encode else y_slices[cfg.ns0 + i]
                  for i in range(cfg.num_prog_slices)]
        if self.stacked:
            y_st = torch.stack(y_prog)
            mu, scale, mask, ms, base_stack = self._prog_stacked(
                quality, mask_pol, lm, ls, y_hat_base, cust_map
            )
            mask = apply_mask_noise(mask)
            _, lik = gaussian_forward((y_st - mu) * mask, scale * mask,
                                      training=training, noise=noise)
            y0 = rnd(y_st - mu) * mask + mu
            y_hat = unstack_channels(self._prog_finish_stacked(ms, y0, base_stack))
            return {"y_hat": y_hat, "lik": unstack_channels(lik), "mu": unstack_channels(mu),
                    "std": unstack_channels(scale), "mask": unstack_channels(mask)}
        prog_slices, mu_total, std_total = [], [], []
        liks, mu_p, std_p, mask_p = [], [], [], []
        for i in range(cfg.num_prog_slices):
            mu, scale, mut, ms = self._prog_slice_nhwc(
                i, lm, ls, y_hat_base, mu_total, std_total, prog_slices
            )
            std_total.append(scale if cfg.support_std else mut)
            mu_total.append(mut)
            mu_p.append(mu)
            std_p.append(scale)
            mu, scale = self._refine_prog_params(
                i, quality, mu, scale, mu_base[i], std_base[i],
                self._hook_anchor(i, y_hat_base, checkpoint_rep), mask_pol, training=training,
            )
            mask = apply_mask_noise(self._mask_for(
                scale, quality, mask_pol, i, y_hat_base[i], self._map_slice(cust_map, i),
                training=training,
            ), mask_ste)
            mask_p.append(mask)
            ys = y_prog[i]
            liks.append(gaussian_forward((ys - mu) * mask, scale * mask,
                                         training=training, noise=noise)[1])
            y0 = rnd(ys - mu) * mask + mu
            prog_slices.append(self._prog_finish(i, ms, y0, y_hat_base[i]))
        cat = lambda ts: torch.cat(ts, dim=-1)  # noqa: E731
        return {"y_hat": cat(prog_slices), "lik": cat(liks), "mu": cat(mu_p), "std": cat(std_p),
                "mask": cat(mask_p)}

    # ------------------------------------------------------------------
    # enhancement and synthesis fragments: channel-last in and out
    # ------------------------------------------------------------------

    def _prog_stacked(self, quality: float, mask_pol, lm, ls, y_hat_base, cust_map=None):
        """-> (mu, scale, mask, mean_support, base_stack), each (S, B, h, w, *)
        channel-last."""
        mu, scale, ms, base_stack = self._prog_params_stacked(
            nchw(lm), nchw(ls), [nchw(y) for y in y_hat_base]
        )
        mu, scale, ms, base_stack = (
            t.permute(0, 1, 3, 4, 2).contiguous() for t in (mu, scale, ms, base_stack)
        )
        mask = stacked_channel_mask(
            scale, pr=quality, mask_pol=mask_pol or "point-based-std",
            dim_chunk=self.cfg.dim_chunk, division_channel=self.cfg.division_channel,
            cust_map=self._map_stack(cust_map),
        )
        return mu, scale, mask, ms, base_stack

    @span("frag:codec_prog_stacked")
    def codec_prog_stacked(self, quality: float, mask_pol, lm, ls, y_hat_base,
                           scale_table, cust_map=None):
        """-> (mu, scale, mask, keep, idx, mean_support, base_stack), each
        (S, B, h, w, *) channel-last."""
        mu, scale, mask, ms, base_stack = self._prog_stacked(
            quality, mask_pol, lm, ls, y_hat_base, cust_map
        )
        keep = torch.round(mask) > 0.5
        idx = build_indexes(scale, scale_table, 0.11)
        return mu, scale, mask, keep, idx, ms, base_stack

    @span("frag:codec_prog_recon_stacked")
    def codec_prog_recon_stacked(self, ms, mu, vals, keep, base_stack):
        zero = torch.zeros((), dtype=torch.float32, device=mu.device)
        y0 = torch.where(keep, vals.reshape(mu.shape).to(torch.float32), zero) + mu
        return self._prog_finish_stacked(ms, y0, base_stack)

    def _prog_finish_stacked(self, ms, y0, base_stack):
        """The stacked enhancement's LRP and residual join, given y0 = the
        dequantised slices plus their means."""
        cfg = self.cfg
        if cfg.residual_before_lrp:
            y0 = y0 + base_stack
        lrp_in = torch.cat([ms, y0], dim=-1)
        lrp = torch.stack([
            self.lrp_transforms_prog[i](nchw(lrp_in[i])) for i in range(lrp_in.shape[0])
        ])
        y0 = y0 + 0.5 * torch.tanh(lrp.permute(0, 1, 3, 4, 2))
        if not cfg.residual_before_lrp:
            y0 = y0 + base_stack
        return y0

    @span("frag:codec_prog_params")
    def codec_prog_params(self, i: int, quality: float, mask_pol, lm, ls, y_hat_base,
                          mu_total, std_total, prog_slices, mu_b_i, std_b_i, checkpoint_slice,
                          scale_table, cust_map_slice=None):
        """Unrolled enhancement slice i: everything whose output feeds an
        index or keep decision -> (mu, scale, mut, mask, keep, idx,
        mean_support), channel-last.  `checkpoint_slice` anchors the
        refinement hook in place of the base slice when given."""
        units = graphs.units()
        mu, scale, mut, ms = units.run(("params", i), self._prog_slice_nhwc, i, lm, ls,
                                       y_hat_base, mu_total, std_total, prog_slices)
        anchor = checkpoint_slice if checkpoint_slice is not None else y_hat_base[i]
        units.prepare(lambda: self._refine_units(i, mu, scale, mu_b_i, std_b_i, anchor))
        mu, scale = self._refine_prog_params(i, quality, mu, scale, mu_b_i, std_b_i, anchor, mask_pol)
        mask = self._mask_for(scale, quality, mask_pol, i, y_hat_base[i], cust_map_slice)
        keep = torch.round(mask) > 0.5
        idx = build_indexes(scale, scale_table, 0.11)
        return mu, scale, mut, mask, keep, idx, ms

    @span("frag:codec_prog_recon")
    def codec_prog_recon(self, i: int, ms, mu, vals, keep, y_b_i):
        """Reconstruction of unrolled enhancement slice i, merged into its base."""
        return graphs.units().run(("recon", i), self._prog_recon, i, ms, mu, vals, keep, y_b_i)

    def _prog_recon(self, i: int, ms, mu, vals, keep, y_b_i):
        zero = torch.zeros((), dtype=torch.float32, device=mu.device)
        y0 = torch.where(keep, vals.reshape(mu.shape).to(torch.float32), zero) + mu
        return self._prog_finish(i, ms, y0, y_b_i)

    def _prog_finish(self, i: int, ms, y0, y_b_i):
        """Unrolled slice i's LRP and join into its base, given y0 = the
        dequantised slice plus its means (channel-last)."""
        cfg = self.cfg
        y0 = nchw(y0)
        base = nchw(y_b_i)
        if cfg.residual_before_lrp:
            y0 = self._merge(y0, base, i)
        lrp_in = torch.cat([nchw(ms), y0], dim=1)
        y0 = y0 + 0.5 * torch.tanh(self.lrp_transforms_prog[i](lrp_in))
        if not cfg.residual_before_lrp:
            y0 = self._merge(y0, base, i)
        return nhwc(y0)

    def _synthesize(self, which: int, y_hat):
        """Synthesis `which` and its refinement, channel-last, not clipped."""
        return nhwc(self._apply_refine(self._synth_net(which)(nchw(y_hat)), which))

    @span("frag:codec_synth")
    def codec_synth(self, which: int, y_hat):
        return torch.clamp(self._synthesize(which, y_hat), 0.0, 1.0)

    def _map_slice(self, cust_map, i: int):
        """Slice i's channels of an importance map, or None."""
        if cust_map is None:
            return None
        dc = self.cfg.dim_chunk
        return cust_map[..., i * dc : (i + 1) * dc]

    def _map_stack(self, cust_map):
        if cust_map is None:
            return None
        dc = self.cfg.dim_chunk
        return torch.stack(
            [cust_map[..., i * dc : (i + 1) * dc] for i in range(self.cfg.num_prog_slices)]
        )
