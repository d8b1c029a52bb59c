"""Plain PyTorch reference of STF, the SymmetricalTransFormer.

Zou, Song and Zhang, "The Devil Is in the Details: Window-based Attention
for Image Compression", CVPR 2022; github.com/Googolxx/STF,
`compressai/models/stf.py` (class `SymmetricalTransFormer`), written as
functions of a state dict named like that file's module tree
(`patch_embed.proj.weight`, `layers.0.blocks.1.attn.qkv.weight`, ...).  It
imports nothing of the program under test; with the flagship's reference
(`model.py`) it shares the convolution helpers, the hyper transforms (whose
widths it reads from the weights), the ChARM parameter stack and the index
rule.

The model, as the repository has no copy of STF's code and this file
writes it down:
  * patch embedding: the image zero-padded to a multiple of the patch (2),
    conv 2x2 stride 2 from 3 to embed_dim channels, LayerNorm;
  * four Swin stages at 1/2 .. 1/16 of the image, widths embed_dim * 2^i,
    depths (2, 2, 6, 2), heads width // 16; each block pre-norm:
    x + W-MSA(LN(x)), then x + MLP(LN(x)); the odd blocks roll the map by
    -window/2 and add the region mask (-100 between regions, Swin's
    constant); a map not a multiple of the window is zero-padded after the
    norm (the padded tokens attend unmasked in plain windows) and cropped
    after; attention with qkv bias, scale head_dim^-0.5 applied to q, a
    (2 ws - 1)^2 x heads relative-position bias; MLP Linear(C, 4C), exact
    GELU, Linear(4C, C); LayerNorm eps 1e-5; window 4;
  * PatchMerging after the first three stages: an odd side zero-padded,
    x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]
    concatenated, LayerNorm(4C), Linear(4C, 2C) without bias; the latent y
    is the last stage's tokens (M = 8 embed_dim channels);
  * the hyperprior and ChARM of WACNN: h_a conv3x3 M -> w0 -> w1 (s2) -> w2
    -> w3 -> N (s2) with GELU between, h_mean_s / h_scale_s conv3x3 N -> w3,
    subpel w3 -> w2, conv w2 -> w1, subpel w1 -> w0, conv w0 -> M, the hyper
    widths N + k (M - N) / 4 (384-336-288-240 at N 192, M 384); M / 32
    slices of 32, each conditioned on the hyper means / scales and the first
    min(i, max_support_slices) decoded slices, LRP 0.5 tanh;
  * the synthesis mirrors the analysis: depths (2, 6, 2, 2), heads reversed,
    PatchSplit after the first three stages (LayerNorm(C), Linear(C, 2C)
    without bias, pixel shuffle 2), then end_conv: conv5x5 embed_dim ->
    4 embed_dim, pixel shuffle 2, conv3x3 embed_dim -> 3.
Departures from the published code: none known; window 4 and MLP ratio 4
are `SymmetricalTransFormer.__init__`'s defaults as recalled, and the
relative-position index is recomputed here rather than read as a buffer.

The floating-point operations follow the published layer order and layout
(tokens (B, L, C), one `torch.nn.functional` call per layer), so that a
program computing the same mathematics in float32 with TF32 off reads the
same bits.  The interface is in `benchmark/reference/__init__.py`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import EB_FILTERS, build_indexes, conv, h_a, h_s, lhwc, stack5
from benchmark.yardstick import _count

F32 = torch.float32
DEPTHS = (2, 2, 6, 2)
WINDOW = 4
MLP_RATIO = 4
PATCH = 2
HEAD_DIM = 16
MASK_FILL = -100.0
LN_EPS = 1e-5
SWIN_STD = 0.02

# Swin's initialisers (trunc_normal_(std=.02) for Linear weights and the
# relative-position tables), drawn as plain normals at that std
INIT_KINDS = {"swin_linear": {"std": SWIN_STD}, "swin_relpos": {"std": SWIN_STD}}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class Cfg:
    """STF's sizes, derived from the configuration file's "model" object:
    embed_dim M // 8, stage widths embed_dim * 2^i, heads max(1, width // 16),
    hyper widths N + k (M - N) / 4, the published depths, window, MLP ratio
    and patch; a "swin" entry in the file has to equal the derived sizes."""

    def __init__(self, model: dict):
        self.name = model.get("name", "stf")
        if self.name != "stf":
            raise NotImplementedError(f"model {self.name!r}")
        self.N = int(model.get("N", 192))
        self.M = int(model.get("M", 640))
        self.dc = int(model.get("dim_chunk", 32))
        self.max_support = int(model.get("max_support_slices", 5))
        st = model.get("scale_table", {})
        self.scale_table = np.exp(np.linspace(np.log(st.get("min", 0.11)), np.log(st.get("max", 256.0)),
                                              int(st.get("levels", 64)))).astype("float64")
        if self.M % 8 or (self.M - self.N) % 4 or self.M % self.dc:
            raise ValueError(f"STF needs M divisible by 8 and by dim_chunk, and M - N by 4: {model}")
        self.embed = self.M // 8
        self.widths = [self.embed * 2**i for i in range(len(DEPTHS))]
        self.heads = [max(1, w // HEAD_DIM) for w in self.widths]
        self.hyper = [self.N + k * (self.M - self.N) // 4 for k in (4, 3, 2, 1)]
        self.num_slices = self.M // self.dc
        derived = {"embed_dim": self.embed, "patch_size": PATCH, "depths": list(DEPTHS),
                   "num_heads": self.heads, "window_size": WINDOW, "mlp_ratio": MLP_RATIO,
                   "qkv_bias": True, "patch_norm": True}
        if "swin" in model and model["swin"] != derived:
            raise ValueError(f"the file's swin sizes {model['swin']} are not those of N and M: {derived}")
        self.swin = derived
        self.base = ""  # the flagship's hyper transforms take a name prefix


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------


def param_spec(cfg: Cfg) -> list:
    """[(name, shape, kind)] of every weight of the model; kinds: conv, bias,
    ones (LayerNorm gains), swin_linear, swin_relpos, the entropy
    bottleneck's."""
    spec: list = []

    def conv_(p, cin, cout, k):
        spec.append((f"{p}.weight", (cout, cin, k, k), "conv"))
        spec.append((f"{p}.bias", (cout,), "bias"))

    def norm(p, c):
        spec.append((f"{p}.weight", (c,), "ones"))
        spec.append((f"{p}.bias", (c,), "bias"))

    def linear(p, cin, cout, bias=True):
        spec.append((f"{p}.weight", (cout, cin), "swin_linear"))
        if bias:
            spec.append((f"{p}.bias", (cout,), "bias"))

    def stage(p, c, depth, heads, resample):
        for j in range(depth):
            b = f"{p}.blocks.{j}"
            norm(f"{b}.norm1", c)
            spec.append((f"{b}.attn.relative_position_bias_table", ((2 * WINDOW - 1) ** 2, heads),
                         "swin_relpos"))
            linear(f"{b}.attn.qkv", c, 3 * c)
            linear(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2", c)
            linear(f"{b}.mlp.fc1", c, MLP_RATIO * c)
            linear(f"{b}.mlp.fc2", MLP_RATIO * c, c)
        if resample == "merge":
            linear(f"{p}.downsample.reduction", 4 * c, 2 * c, bias=False)
            norm(f"{p}.downsample.norm", 4 * c)
        elif resample == "split":
            linear(f"{p}.downsample.reduction", c, 2 * c, bias=False)
            norm(f"{p}.downsample.norm", c)

    e, n, m, dc = cfg.embed, cfg.N, cfg.M, cfg.dc
    last = len(DEPTHS) - 1
    conv_("patch_embed.proj", 3, e, PATCH)
    norm("patch_embed.norm", e)
    for i in range(len(DEPTHS)):
        stage(f"layers.{i}", cfg.widths[i], DEPTHS[i], cfg.heads[i], "merge" if i < last else None)
    for i in range(len(DEPTHS)):
        stage(f"syn_layers.{i}", cfg.widths[last - i], DEPTHS[last - i], cfg.heads[last - i],
              "split" if i < last else None)
    conv_("end_conv.0", e, e * PATCH**2, 5)
    conv_("end_conv.2", e, 3, 3)
    c = m
    for j, w in enumerate(cfg.hyper + [n]):
        conv_(f"h_a.{2 * j}", c, w, 3)
        c = w
    w0, w1, w2, w3 = cfg.hyper[::-1]
    for h in ("h_mean_s", "h_scale_s"):
        conv_(f"{h}.0", n, w0, 3)
        conv_(f"{h}.2.0", w0, w1 * 4, 3)
        conv_(f"{h}.4", w1, w2, 3)
        conv_(f"{h}.6.0", w2, w3 * 4, 3)
        conv_(f"{h}.8", w3, m, 3)
    cins = [m + dc * min(i, cfg.max_support) for i in range(cfg.num_slices)]
    for bank, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0), ("lrp_transforms", dc)):
        for i, cin in enumerate(cins):
            c = cin + extra
            for j, w in enumerate((224, 176, 128, 64, dc)):
                conv_(f"{bank}.{i}.{2 * j}", c, w, 3)
                c = w
    eb = "entropy_bottleneck"
    for i in range(5):
        spec.append((f"{eb}._matrix{i}", (n, EB_FILTERS[i + 1], EB_FILTERS[i]), "eb_matrix"))
        spec.append((f"{eb}._bias{i}", (n, EB_FILTERS[i + 1], 1), "eb_bias"))
        if i < 4:
            spec.append((f"{eb}._factor{i}", (n, EB_FILTERS[i + 1], 1), "eb_factor"))
    spec.append((f"{eb}.quantiles", (n, 1, 3), "eb_quantiles"))
    return spec


# ---------------------------------------------------------------------------
# the Swin layers (tokens (B, L, C))
# ---------------------------------------------------------------------------


def layer_norm(P, p, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{p}.weight"], P[f"{p}.bias"], LN_EPS)


def rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).reshape(-1)


def region_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2): MASK_FILL between tokens of different regions of the
    rolled, padded map, 0 within one."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, MASK_FILL, 0.0).astype(np.float32)


def window_partition(x, ws):
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(xw, ws, h, w):
    c = xw.shape[-1]
    b = xw.shape[0] // ((h // ws) * (w // ws))
    return xw.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_attention(P, p, xw, heads, mask, n_win):
    """Multi-head self-attention inside each window of xw (B*nW, n, C)."""
    b_, n, c = xw.shape
    hd = c // heads
    qkv = F.linear(xw, P[f"{p}.qkv.weight"], P[f"{p}.qkv.bias"])
    qkv = qkv.reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul(q * hd**-0.5, k.transpose(-2, -1))
    idx = torch.as_tensor(rel_pos_index(WINDOW), device=xw.device)
    rel = P[f"{p}.relative_position_bias_table"][idx]
    attn = attn + rel.reshape(n, n, heads).permute(2, 0, 1)[None]
    if mask is not None:
        attn = attn.reshape(-1, n_win, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
    return F.linear(out, P[f"{p}.proj.weight"], P[f"{p}.proj.bias"])


def swin_block(P, p, x, h, w, heads, shift, mask):
    b, _, c = x.shape
    ws = WINDOW
    xs = layer_norm(P, f"{p}.norm1", x).reshape(b, h, w, c)
    pad_r, pad_b = -w % ws, -h % ws
    if pad_r or pad_b:
        xs = F.pad(xs, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift:
        xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
    n_win = (hp // ws) * (wp // ws)
    out = window_attention(P, f"{p}.attn", window_partition(xs, ws), heads, mask if shift else None, n_win)
    out = window_reverse(out, ws, hp, wp)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    if pad_r or pad_b:
        out = out[:, :h, :w, :].contiguous()
    x = x + out.reshape(b, h * w, c)
    hid = F.gelu(F.linear(layer_norm(P, f"{p}.norm2", x), P[f"{p}.mlp.fc1.weight"], P[f"{p}.mlp.fc1.bias"]))
    return x + F.linear(hid, P[f"{p}.mlp.fc2.weight"], P[f"{p}.mlp.fc2.bias"])


def patch_merge(P, p, x, h, w):
    b, _, c = x.shape
    x = x.reshape(b, h, w, c)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = layer_norm(P, f"{p}.norm", x.reshape(b, -1, 4 * c))
    return F.linear(x, P[f"{p}.reduction.weight"]), (h + 1) // 2, (w + 1) // 2


def patch_split(P, p, x, h, w):
    b, n, c = x.shape
    x = F.linear(layer_norm(P, f"{p}.norm", x), P[f"{p}.reduction.weight"])
    x = F.pixel_shuffle(x.permute(0, 2, 1).contiguous().reshape(b, 2 * c, h, w), 2)
    return x.permute(0, 2, 3, 1).contiguous().reshape(b, 4 * n, -1), 2 * h, 2 * w


def swin_stage(P, p, x, h, w, depth, heads, resample):
    ws = WINDOW
    mask = None
    if depth > 1:
        mask = torch.as_tensor(region_mask(-(-h // ws) * ws, -(-w // ws) * ws, ws, ws // 2), device=x.device)
    for j in range(depth):
        x = swin_block(P, f"{p}.blocks.{j}", x, h, w, heads, 0 if j % 2 == 0 else ws // 2, mask)
    if resample is None:
        return x, h, w
    return resample(P, f"{p}.downsample", x, h, w)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


def g_a(P, cfg, x):
    """x NCHW (B, 3, H, W) -> y NCHW (B, M, h, w)."""
    pad_r, pad_b = -x.shape[3] % PATCH, -x.shape[2] % PATCH
    if pad_r or pad_b:
        x = F.pad(x, (0, pad_r, 0, pad_b))
    x = F.conv2d(x, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"], stride=PATCH)
    h, w = x.shape[2], x.shape[3]
    t = layer_norm(P, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    last = len(DEPTHS) - 1
    for i in range(len(DEPTHS)):
        t, h, w = swin_stage(P, f"layers.{i}", t, h, w, DEPTHS[i], cfg.heads[i],
                             patch_merge if i < last else None)
    return t.reshape(t.shape[0], h, w, cfg.M).permute(0, 3, 1, 2).contiguous()


def g_s(P, cfg, y):
    """y NCHW (B, M, h, w) -> x_hat NCHW (B, 3, 16h, 16w), not clipped."""
    b, _, h, w = y.shape
    t = y.permute(0, 2, 3, 1).contiguous().reshape(b, h * w, cfg.M)
    last = len(DEPTHS) - 1
    for i in range(len(DEPTHS)):
        t, h, w = swin_stage(P, f"syn_layers.{i}", t, h, w, DEPTHS[last - i], cfg.heads[last - i],
                             patch_split if i < last else None)
    x = t.reshape(b, h, w, cfg.embed).permute(0, 3, 1, 2).contiguous()
    x = F.pixel_shuffle(conv(P, "end_conv.0", x), PATCH)
    return conv(P, "end_conv.2", x)


# ---------------------------------------------------------------------------
# one request
# ---------------------------------------------------------------------------


@torch.no_grad()
def reference_request(P, cfg: Cfg, x, quality: float, medians=None) -> dict:
    """x (B, H, W, 3) in [0, 1] -> {"stages": z, then the M / dim_chunk
    slices, each (symbols, rows of the merged table, keep) flat in coding
    order, "y_hat" channel-last, "x_hat" (B, H, W, 3) clipped}.  A
    single-rate model: the quality changes nothing."""
    table32 = torch.as_tensor(cfg.scale_table.astype(np.float32), device=x.device)
    row0 = cfg.N
    y = g_a(P, cfg, x.permute(0, 3, 1, 2).contiguous())
    z = h_a(P, cfg, y)
    med = P["entropy_bottleneck.quantiles"][:, 0, 1] if medians is None else medians
    z_sym = torch.round(z - med.reshape(1, -1, 1, 1))
    z_hat = z_sym + med.reshape(1, -1, 1, 1)
    lm, ls = h_s(P, cfg, "h_mean_s", z_hat), h_s(P, cfg, "h_scale_s", z_hat)
    zrows = torch.arange(cfg.N, dtype=torch.int32, device=x.device).reshape(1, -1, 1, 1).expand(z.shape)
    stages = [(lhwc(z_sym), lhwc(zrows), torch.ones_like(lhwc(z_sym), dtype=torch.bool))]
    y_slices = torch.split(y, cfg.dc, dim=1)
    y_hat = []
    for i in range(cfg.num_slices):
        support = y_hat[: min(i, cfg.max_support)]
        mean_support = torch.cat([lm] + support, dim=1)
        mu = stack5(P, f"cc_mean_transforms.{i}", mean_support)
        scale = stack5(P, f"cc_scale_transforms.{i}", torch.cat([ls] + support, dim=1))
        sym = torch.round(y_slices[i] - mu)
        stages.append((lhwc(sym), lhwc(build_indexes(scale, table32) + row0),
                       torch.ones_like(lhwc(sym), dtype=torch.bool)))
        y0 = sym + mu
        lrp = stack5(P, f"lrp_transforms.{i}", torch.cat([mean_support, y0], dim=1))
        y_hat.append(y0 + 0.5 * torch.tanh(lrp))
    y_hat = torch.cat(y_hat, dim=1)
    x_hat = torch.clamp(g_s(P, cfg, y_hat), 0.0, 1.0)
    flat = [(s.reshape(-1).to(torch.int32), r.reshape(-1).to(torch.int32), k.reshape(-1).to(torch.bool))
            for s, r, k in stages]
    return {"stages": flat, "y_hat": lhwc(y_hat), "x_hat": lhwc(x_hat)}


# ---------------------------------------------------------------------------
# the container's stages and the round trip's FLOPs
# ---------------------------------------------------------------------------


def stage_sizes(cfg: Cfg, batch: int, h: int, w: int, quality: float) -> list:
    """Symbols per stage: z at 1/64, then every slice at 1/16."""
    hy, wy = h // 16, w // 16
    return [batch * (hy // 4) * (wy // 4) * cfg.N] + [batch * hy * wy * cfg.dc] * cfg.num_slices


def chain_flops(cfg: Cfg, batch: int, h: int, w: int, quality: float) -> int:
    """FLOPs (convolutions and products) one request needs, counted over meta
    tensors: 2 x the forward, less the analysis and hyper analysis the
    decoder skips and the synthesis the encoder skips."""
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, s, _ in param_spec(cfg)}
    x = torch.empty((batch, h, w, 3), device=meta)
    med = torch.empty((cfg.N,), device=meta)
    fwd = _count(lambda: reference_request(P, cfg, x, quality, medians=med))
    y = torch.empty((batch, cfg.M, h // 16, w // 16), device=meta)
    ga = _count(lambda: g_a(P, cfg, torch.empty((batch, 3, h, w), device=meta)))
    ha = _count(lambda: h_a(P, cfg, y))
    gs = _count(lambda: g_s(P, cfg, y))
    return 2 * fwd - ga - ha - gs
