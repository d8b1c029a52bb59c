"""Weights for the port: the JAX parameter tree mapped to a reference-named
state dict, and a seeded initialiser that mirrors the JAX initialisers.

`from_jax_params` is the port's own copy of the mappings in
`progressivecodec_tpu/models/torch_import.py` (`export_progressive`,
`export_wacnn`, `export_rem`) for ChannelProgressiveWACNN, stacked or
unrolled, with joiners, learnable masks and u_net_post refinement, for
WACNN, and for REM (the base tree under `base_net.`, the
LatentRateReduction banks under `post_latent.{k}.{i}.`):

  conv kernel     HWIO        -> OIHW   (transpose 3, 2, 0, 1)
  deconv kernel   HWIO        -> IOHW   (transpose 2, 3, 0, 1)
  linear kernel   (in, out)   -> (out, in)   (REM's zero_out Dense too)
  stacked enhancement bank    -> one ConvStack5 per slice
  GDN, bottleneck, rel-pos tables   copied

The port's module tree carries the reference's names, so the result loads
with `load_state_dict(strict=True)`.  A reference checkpoint (`.pth`) loads
the same way through `load_pth`: it unwraps `{"state_dict": ...}`, strips
DataParallel's `module.` and drops, by name, the buffers of the reference's
CompressAI modules that the port does not hold (`REFERENCE_BUFFERS`), all
of which `Codec.update()` or the configuration determine (the window
attention's `relative_position_index` follows from the window size).  So
do STF's and TCM's checkpoints (TCM's window attention stores no index).
`from_jax_module` maps the small modules whose port children carry JAX's
names (the MaskEstractor, the postnets).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.layers.blocks import GDN, WindowAttention, WinNoShiftAttention
from progressivecodec_tpu_torch.models.progressive import uses_stacked_prog
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.rem import reference_name
from progressivecodec_tpu_torch.ops.math import nonneg_init

F32 = torch.float32
PROG_BANKS = ("cc_mean_prog", "cc_scale_prog", "lrp_prog")


def _t(a) -> torch.Tensor:
    """A float32 copy: JAX's arrays are read-only views of its buffers."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def put_conv(sd: dict, prefix: str, node) -> None:
    sd[prefix + "weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
    sd[prefix + "bias"] = _t(node["bias"])


def put_deconv(sd: dict, prefix: str, node) -> None:
    sd[prefix + "weight"] = _t(np.transpose(node["kernel"], (2, 3, 0, 1)))
    sd[prefix + "bias"] = _t(node["bias"])


def put_gdn(sd: dict, prefix: str, node) -> None:
    sd[prefix + "beta"] = _t(node["beta"])
    sd[prefix + "gamma"] = _t(node["gamma"])


def put_rb(sd: dict, prefix: str, node) -> None:
    """A ResidualBlock (conv1, conv2, and `skip` where JAX has one: only
    where the widths differ)."""
    put_conv(sd, f"{prefix}conv1.", node["conv1"])
    put_conv(sd, f"{prefix}conv2.", node["conv2"])
    if "skip" in node:
        put_conv(sd, f"{prefix}skip.", node["skip"])


def _put_ru(sd: dict, prefix: str, node) -> None:
    for j, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
        put_conv(sd, f"{prefix}{j}.", node[name])


def put_attn(sd: dict, prefix: str, node) -> None:
    """A WinNoShiftAttention block."""
    for r in range(3):
        _put_ru(sd, f"{prefix}conv_a.{r}.conv.", node[f"a_res{r}"])
    ap = f"{prefix}conv_b.0.attn."
    a = node["attn"]
    sd[ap + "qkv.weight"] = _t(np.transpose(a["qkv_kernel"]))
    sd[ap + "qkv.bias"] = _t(a["qkv_bias"])
    sd[ap + "proj.weight"] = _t(np.transpose(a["proj_kernel"]))
    sd[ap + "proj.bias"] = _t(a["proj_bias"])
    sd[ap + "relative_position_bias_table"] = _t(a["rel_pos_bias"])
    for r in range(3):
        _put_ru(sd, f"{prefix}conv_b.{r + 1}.conv.", node[f"b_res{r}"])
    put_conv(sd, f"{prefix}conv_b.4.", node["b_proj"])


def from_jax_module(params_np: dict, module: nn.Module, prefix: str = "") -> dict:
    """JAX params of a module whose port counterpart names its children as
    JAX names them (the MaskEstractor, the postnets and their residual
    blocks) -> the port module's state dict.  Convs and deconvs are
    transposed, GDN and window attention mapped as in `from_jax_params`; a
    child that JAX lacks, or a `skip` that only JAX has, raises or fails the
    strict load."""
    sd: dict = {}
    for name, child in module.named_children():
        node, p = params_np[name], f"{prefix}{name}."
        if isinstance(child, nn.ConvTranspose2d):
            put_deconv(sd, p, node)
        elif isinstance(child, nn.Conv2d):
            put_conv(sd, p, node)
        elif isinstance(child, GDN):
            put_gdn(sd, p, node)
        elif isinstance(child, WinNoShiftAttention):
            put_attn(sd, p, node)
        else:
            sd.update(from_jax_module(node, child, p))
    return sd


def from_jax_params(params_np: dict, cfg: ModelConfig) -> dict:
    """JAX `variables["params"]` (numpy leaves) of the model `cfg` names ->
    state dict of float32 CPU tensors named like the reference."""
    sd: dict = {}

    def put_analysis(prefix, node):
        put_conv(sd, f"{prefix}0.", node["conv0"])
        put_gdn(sd, f"{prefix}1.", node["gdn0"])
        put_conv(sd, f"{prefix}2.", node["conv1"])
        put_gdn(sd, f"{prefix}3.", node["gdn1"])
        put_attn(sd, f"{prefix}4.", node["attn0"])
        put_conv(sd, f"{prefix}5.", node["conv2"])
        put_gdn(sd, f"{prefix}6.", node["gdn2"])
        put_conv(sd, f"{prefix}7.", node["conv3"])
        put_attn(sd, f"{prefix}8.", node["attn1"])

    def put_synthesis(prefix, node):
        put_attn(sd, f"{prefix}0.", node["attn0"])
        put_deconv(sd, f"{prefix}1.", node["deconv0"])
        put_gdn(sd, f"{prefix}2.", node["igdn0"])
        put_deconv(sd, f"{prefix}3.", node["deconv1"])
        put_gdn(sd, f"{prefix}4.", node["igdn1"])
        put_attn(sd, f"{prefix}5.", node["attn1"])
        put_deconv(sd, f"{prefix}6.", node["deconv2"])
        put_gdn(sd, f"{prefix}7.", node["igdn2"])
        put_deconv(sd, f"{prefix}8.", node["deconv3"])

    def put_hyper_synthesis(prefix, node):
        put_conv(sd, f"{prefix}0.", node["conv0"])
        put_conv(sd, f"{prefix}2.0.", node["up0"]["conv"])
        put_conv(sd, f"{prefix}4.", node["conv1"])
        put_conv(sd, f"{prefix}6.0.", node["up1"]["conv"])
        put_conv(sd, f"{prefix}8.", node["conv2"])

    def put_stack5(prefix, node):
        for j in range(5):
            put_conv(sd, f"{prefix}{2 * j}.", node[f"conv{j}"])

    def put_bank(prefix, node, n):
        for i in range(n):
            put_stack5(f"{prefix}{i}.", node[f"s{i}"])

    def put_lrr(prefix, node):  # REM LatentRateReduction
        for ref, name in (("enc_base_entropy_params", "base_ent"), ("enc_enh_entropy_params", "enh_ent"),
                          ("enc_base_rep", "base_rep"), ("enc", "enc")):
            j = 0
            while f"{name}{j}" in node:
                put_rb(sd, f"{prefix}{ref}.{j}.", node[f"{name}{j}"])
                j += 1
        sd[f"{prefix}zero_out.weight"] = _t(np.transpose(node["zero_out"]["kernel"]))
        sd[f"{prefix}zero_out.bias"] = _t(node["zero_out"]["bias"])

    def put_cbr(prefix, node):  # UNet ConvBlockResidual
        put_conv(sd, f"{prefix}conv.0.", node["conv1"])
        put_conv(sd, f"{prefix}conv.2.", node["conv2"])
        sd[f"{prefix}conv.3.fc.0.weight"] = _t(np.transpose(node["se"]["fc1"]))
        sd[f"{prefix}conv.3.fc.2.weight"] = _t(np.transpose(node["se"]["fc2"]))
        put_conv(sd, f"{prefix}up_dim.", node["up_dim"])

    def put_refine(prefix, node):  # Sequential(UNet, conv3x3)
        unet = node["layers_0"]
        for name in ("conv1", "conv2", "conv3", "up_conv3", "up_conv2"):
            put_cbr(f"{prefix}0.{name}.", unet[name])
        for i in range(4):
            put_conv(sd, f"{prefix}0.context_refine.{i}.conv1.", unet[f"refine{i}"]["conv1"])
            put_conv(sd, f"{prefix}0.context_refine.{i}.conv2.", unet[f"refine{i}"]["conv2"])
        put_conv(sd, f"{prefix}0.up3.0.", unet["up3"]["conv"])
        put_conv(sd, f"{prefix}0.up2.0.", unet["up2"]["conv"])
        put_conv(sd, f"{prefix}1.", node["layers_1"])

    p = params_np
    wacnn = cfg.name == "cnn"  # one of each transform, M // dim_chunk slices
    if cfg.multiple_encoder and not wacnn:
        put_analysis("g_a.0.", p["g_a0"])
        put_analysis("g_a.1.", p["g_a1"])
    else:
        put_analysis("g_a.", p["g_a"])
    if cfg.multiple_decoder and not wacnn:
        put_synthesis("g_s.0.", p["g_s0"])
        put_synthesis("g_s.1.", p["g_s1"])
    else:
        put_synthesis("g_s.", p["g_s"])
    put_stack5("h_a.", p["h_a"])
    if cfg.multiple_hyperprior and not wacnn:
        for i in range(2):
            put_hyper_synthesis(f"h_mean_s.{i}.", p[f"h_mean_s{i}"])
            put_hyper_synthesis(f"h_scale_s.{i}.", p[f"h_scale_s{i}"])
    else:
        put_hyper_synthesis("h_mean_s.", p["h_mean_s"])
        put_hyper_synthesis("h_scale_s.", p["h_scale_s"])
    n_base = cfg.M // cfg.dim_chunk if wacnn else cfg.ns0
    for bank, ref in (("cc_mean", "cc_mean_transforms"), ("cc_scale", "cc_scale_transforms"),
                      ("lrp", "lrp_transforms")):
        put_bank(f"{ref}.", p[bank], n_base)
    if not wacnn:
        for bank in PROG_BANKS:
            ref = bank.replace("_prog", "_transforms_prog") + "."
            if uses_stacked_prog(cfg):  # each leaf carries a leading slice axis
                for i in range(cfg.num_prog_slices):
                    put_stack5(f"{ref}{i}.", {
                        conv: {pn: np.asarray(v)[i] for pn, v in leaves.items()}
                        for conv, leaves in p[bank].items()
                    })
            else:  # the unrolled lrp bank has ns0 entries
                put_bank(ref, p[bank], cfg.ns0 if bank == "lrp_prog" else cfg.num_prog_slices)
        if cfg.joiner_policy in ("cond", "channel_cond", "channel_res"):
            for i in range(cfg.ns0):
                for j in range(3):
                    put_conv(sd, f"joiner.{i}.{2 * j}.", p[f"joiner{i}"][f"conv{j}"])
        if "learnable" in cfg.mask_policy:
            for i in range(cfg.num_prog_slices):
                node = p[f"mask_conv{i}"]
                for prefix, conv in (("0.", node["conv0"]), ("2.", node["conv1"]),
                                     ("4.0.", node["up"]["conv"]), ("6.", node["conv2"])):
                    put_conv(sd, f"masking.mask_conv.{i}.{prefix}", conv)
        if cfg.u_net_post == 1:
            put_refine("refine.", p["refine"])
        elif cfg.u_net_post == 2:
            for i in range(2):
                put_refine(f"refine.{i}.", p[f"refine{i}"])
    eb = p["entropy_bottleneck"]
    for i in range(5):
        sd[f"entropy_bottleneck._matrix{i}"] = _t(eb[f"matrix{i}"])
        sd[f"entropy_bottleneck._bias{i}"] = _t(eb[f"bias{i}"])
        if i < 4:
            sd[f"entropy_bottleneck._factor{i}"] = _t(eb[f"factor{i}"])
    sd["entropy_bottleneck.quantiles"] = _t(eb["quantiles"])
    if cfg.name == "rate":
        sd = {reference_name(k): v for k, v in sd.items()}
        for k in range(len(cfg.check_levels)):
            for i in range(cfg.ns0):  # as many banks per level as rem.py builds
                put_lrr(f"post_latent.{k}.{i}.", p[f"post_latent{k}_{i}"])
    return sd


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Seeded state dict (float32, CPU) of the model `cfg` names, drawn as
    the JAX initialisers draw:
    Kaiming-normal fan_out convs and deconvs with zero biases, GDN beta = 1
    and gamma = 0.1 I in reparam space, lecun-normal (truncated) attention
    linears, truncated-normal(0.02) relative-position tables, the
    bottleneck's own init, and zeros for REM's `zero_out` projections (each
    bank starts as the identity).  Names are the model's `state_dict()`
    names.  The numbers differ from JAX's for the same seed."""
    skeleton = get_model(cfg, device="meta")
    sd: dict = {}

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=F32) * std

    def trunc(shape, std):
        t = torch.empty(shape, dtype=F32)
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)

    for name, mod in skeleton.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, nn.Conv2d):
            o, _, kh, kw = mod.weight.shape
            sd[p + "weight"] = normal(mod.weight.shape, math.sqrt(2.0 / (kh * kw * o)))
            sd[p + "bias"] = torch.zeros(mod.bias.shape, dtype=F32)
        elif isinstance(mod, nn.ConvTranspose2d):
            _, o, kh, kw = mod.weight.shape
            sd[p + "weight"] = normal(mod.weight.shape, math.sqrt(2.0 / (kh * kw * o)))
            sd[p + "bias"] = torch.zeros(mod.bias.shape, dtype=F32)
        elif isinstance(mod, nn.Linear) and name.endswith("zero_out"):
            sd[p + "weight"] = torch.zeros(mod.weight.shape, dtype=F32)
            sd[p + "bias"] = torch.zeros(mod.bias.shape, dtype=F32)
        elif isinstance(mod, nn.Linear):
            fan_in = mod.weight.shape[1]
            sd[p + "weight"] = trunc(mod.weight.shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            if mod.bias is not None:
                sd[p + "bias"] = torch.zeros(mod.bias.shape, dtype=F32)
        elif isinstance(mod, GDN):
            c = mod.beta.shape[0]
            sd[p + "beta"] = nonneg_init(torch.ones(c, dtype=F32))
            sd[p + "gamma"] = nonneg_init(mod.gamma_init * torch.eye(c, dtype=F32))
        elif isinstance(mod, WindowAttention):
            sd[p + "relative_position_bias_table"] = trunc(
                mod.relative_position_bias_table.shape, 0.02
            )
        elif isinstance(mod, EntropyBottleneck):
            eb = EntropyBottleneck(mod.channels, mod.tail_mass, mod.init_scale, device="cpu")
            eb.reset_parameters(generator)
            sd.update({p + k: v for k, v in eb.state_dict().items()})
    if cfg.name == "rate":
        sd = {reference_name(k): v for k, v in sd.items()}
    return sd


# The buffers upstream CompressAI registers on the modules of a reference
# model, none of which the port holds: every EntropyModel's CDF bookkeeping
# (`_offset`, `_quantized_cdf`, `_cdf_length`, rebuilt by `update()`) and
# its likelihood LowerBound, the EntropyBottleneck's `target`, the
# GaussianConditional's `scale_table`, `scale_bound` and scale LowerBound,
# and the NonNegativeParametrizer constants of each GDN's beta and gamma.
# A key is dropped when it ends in "." + one of these.
REFERENCE_BUFFERS = (
    "_offset", "_quantized_cdf", "_cdf_length", "likelihood_lower_bound.bound",
    "target",
    "scale_table", "scale_bound", "lower_bound_scale.bound",
    "beta_reparam.pedestal", "beta_reparam.lower_bound.bound",
    "gamma_reparam.pedestal", "gamma_reparam.lower_bound.bound",
    "relative_position_index",
)


def strip_prefixes(sd) -> dict:
    """Remove DataParallel's `module.` prefix from every key that has it."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_pth(path_or_dict, cfg: ModelConfig) -> dict:
    """A reference checkpoint (a `.pth` path, or the dict `torch.load` gave)
    -> the state dict of the model `cfg` names, as float32 CPU tensors.

    Reads with `weights_only=True`, unwraps `{"state_dict": ...}`, strips
    `module.`, drops `REFERENCE_BUFFERS` by name, and checks what is left
    with `load_state_dict(strict=True)` against the model's skeleton, so a
    missing key, an unknown key or a wrong shape raises.  REM's `base_net.`
    names load as `models/rem.py` loads them."""
    ckpt = path_or_dict
    if not isinstance(ckpt, dict):
        ckpt = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    sd = strip_prefixes(ckpt.get("state_dict", ckpt))
    sd = {k: torch.as_tensor(v, dtype=F32).contiguous() for k, v in sd.items()
          if not k.endswith(tuple("." + b for b in REFERENCE_BUFFERS))}
    get_model(cfg, device="meta").load_state_dict(sd, strict=True, assign=True)
    return sd
