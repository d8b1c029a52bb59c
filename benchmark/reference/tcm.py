"""Plain PyTorch reference of TCM, the mixed Transformer-CNN codec.

Liu, Sun and Katto, "Learned Image Compression with Mixed Transformer-CNN
Architectures", CVPR 2023; github.com/jmliu206/LIC_TCM, `models/tcm.py`
(class `TCM`), written as functions of a state dict named like that file's
module tree (`g_a.1.trans_block.msa.embedding_layer.weight`,
`atten_mean.0.0.non_local_block.block_2.ln1.weight`, ...).  It imports
nothing of the program under test; with the flagship's reference
(`model.py`) it shares the convolution, GDN and index helpers, and with
STF's (`stf.py`) the window partition, the shifted-window region mask and
the relative-position index.

The model, as the repository has no copy of TCM's code and this file
writes it down (N 128, M 320 are the published defaults):
  * ConvTransBlock (CTB) on 2N channels: conv1x1 2N -> 2N, split into a CNN
    half and a Transformer half of N each; the CNN half
    x + ResidualBlock(x) (CompressAI's: conv3x3, LeakyReLU, conv3x3,
    LeakyReLU, plus the input); the Transformer half a pre-norm block
    x + MSA(LN(x)), then x + MLP(LN(x)) in (B, H, W, C) tokens, the MLP
    Linear(C, 4C), exact GELU, Linear(4C, C); the halves concatenated,
    conv1x1 2N -> 2N, added to the block's input.  Blocks alternate plain
    (W) and shifted (SW) windows;
  * MSA (SCUNet's WMSA): shifted windows roll the map by -window/2 first and
    back after; qkv by one Linear(C, 3C) whose output splits as
    (3 heads, head_dim); logits q k^T, then times head_dim^-0.5, plus a
    relative-position bias read from a (heads, 2 ws - 1, 2 ws - 1) table,
    then -inf where the shifted windows of the last window row or column
    join tokens of different regions; softmax; times v; Linear(C, C);
  * g_a: ResidualBlockWithStride(3, 2N); two CTBs of head width 8;
    ResidualBlockWithStride(2N, 2N); two CTBs of 16; again; two CTBs of 32;
    conv3x3 2N -> M stride 2.  Window 8.  ResidualBlockWithStride is
    CompressAI's: conv3x3 stride 2, LeakyReLU, conv3x3, GDN, plus a conv1x1
    stride 2 skip;
  * g_s: ResidualBlockUpsample(M, 2N); two CTBs of 32;
    ResidualBlockUpsample(2N, 2N); two CTBs of 16; again; two CTBs of 8;
    subpel conv3x3 2N -> 3.  ResidualBlockUpsample is CompressAI's: subpel
    conv3x3, LeakyReLU, conv3x3, inverse GDN, plus a subpel conv3x3 skip;
  * h_a: ResidualBlockWithStride(M, 2N), two CTBs of head width 32 in
    windows of 4, conv3x3 2N -> 192 stride 2; h_mean_s and h_scale_s:
    ResidualBlockUpsample(192, 2N), two such CTBs, subpel conv3x3 2N -> M.
    z has 192 channels whatever N is;
  * five slices of M / 5, each slice's mean (scale) support, the hyper means
    (scales) and the first min(i, 5) decoded slices, through the slice's
    SWAtten, then conv3x3 -> 224, GELU, conv3x3 -> 128, GELU, conv3x3 ->
    M / 5; the LRP reads the attended mean support and the slice, 0.5 tanh;
  * SWAtten: conv1x1 -> 128, then CompressAI's AttentionBlock on 128
    channels (three residual units conv1x1 -> 64, ReLU, conv3x3, ReLU,
    conv1x1 -> 128, plus the input, ReLU, on each branch; a conv1x1 closing
    conv_b; x + conv_a(x) * sigmoid(conv_b(.))) whose conv_b reads a
    two-block Swin (W, then SW; head width 16, window 8) of the input
    instead of the input; conv1x1 back.
Departures from the published code: the window products are `matmul`
where TCM writes `einsum` (the same contractions); no padding branch: TCM's
`SwinBlock` pads a map no larger than one window, which the benchmark's
shapes never reach (the program refuses such images), so it is left out.

The floating-point operations follow the published layer order and layout
(NCHW convolutions, the Transformer half on the permuted view as TCM's
`Rearrange` leaves it), so that a program computing the same mathematics in
float32 with TF32 off reads the same bits.  The interface is in
`benchmark/reference/__init__.py`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import EB_FILTERS, build_indexes, conv, gdn, lhwc
from benchmark.reference.stf import region_mask, rel_pos_index, window_partition, window_reverse
from benchmark.yardstick import _count

DEPTHS = (2, 2, 2, 2, 2, 2)
HEAD_DIM = (8, 16, 32, 32, 16, 8)
WINDOW = 8
HYPER_WINDOW = 4
HYPER_HEAD_DIM = 32
MLP_RATIO = 4
ATTEN_DIM = 128
ATTEN_HEAD_DIM = 16
Z_CHANNELS = 192
NUM_SLICES = 5
MAX_SUPPORT = 5
LN_EPS = 1e-5
LEAKY_SLOPE = 0.01
TCM_STD = 0.02

# Linear weights and relative-position tables drawn N(0, 0.02^2), as STF's
# seeded weights are (TCM keeps PyTorch's default Linear init and draws its
# tables trunc_normal_(std=.02))
INIT_KINDS = {"tcm_linear": {"std": TCM_STD}, "tcm_relpos": {"std": TCM_STD}}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class Cfg:
    """TCM's sizes from the configuration file's "model" object: the block
    width `width` (TCM's N), the latent's M, the slices M / dim_chunk; `N`
    is z's channel count, 192.  A "tcm" entry in the file has to equal the
    published constants."""

    def __init__(self, model: dict):
        self.name = model.get("name", "tcm")
        if self.name != "tcm":
            raise NotImplementedError(f"model {self.name!r}")
        self.width = int(model.get("N", 128))
        self.M = int(model.get("M", 320))
        self.dc = int(model.get("dim_chunk", 64))
        self.max_support = int(model.get("max_support_slices", MAX_SUPPORT))
        st = model.get("scale_table", {})
        self.scale_table = np.exp(np.linspace(np.log(st.get("min", 0.11)), np.log(st.get("max", 256.0)),
                                              int(st.get("levels", 64)))).astype("float64")
        if self.M % self.dc or any(self.width % h for h in HEAD_DIM + (HYPER_HEAD_DIM,)):
            raise ValueError(f"TCM needs M divisible by dim_chunk and N by every head width: {model}")
        self.N = Z_CHANNELS
        self.num_slices = self.M // self.dc
        derived = {"config": list(DEPTHS), "head_dim": list(HEAD_DIM), "window_size": WINDOW,
                   "hyper_window_size": HYPER_WINDOW, "hyper_head_dim": HYPER_HEAD_DIM,
                   "mlp_ratio": MLP_RATIO, "atten_dim": ATTEN_DIM, "atten_head_dim": ATTEN_HEAD_DIM,
                   "z_channels": Z_CHANNELS, "num_slices": self.num_slices, "drop_path_rate": 0}
        if "tcm" in model and model["tcm"] != derived:
            raise ValueError(f"the file's tcm sizes {model['tcm']} are not TCM's: {derived}")
        self.tcm = derived


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------


def param_spec(cfg: Cfg) -> list:
    """[(name, shape, kind)] of every weight of the model, in the program's
    state-dict order; kinds: conv, bias, ones (LayerNorm gains), gdn_beta,
    gdn_gamma, tcm_linear, tcm_relpos, the entropy bottleneck's."""
    spec: list = []

    def conv_(p, cin, cout, k):
        spec.append((f"{p}.weight", (cout, cin, k, k), "conv"))
        spec.append((f"{p}.bias", (cout,), "bias"))

    def norm(p, c):
        spec.append((f"{p}.weight", (c,), "ones"))
        spec.append((f"{p}.bias", (c,), "bias"))

    def linear(p, cin, cout):
        spec.append((f"{p}.weight", (cout, cin), "tcm_linear"))
        spec.append((f"{p}.bias", (cout,), "bias"))

    def gdn_(p, c):
        spec.append((f"{p}.beta", (c,), "gdn_beta"))
        spec.append((f"{p}.gamma", (c, c), "gdn_gamma"))

    def block(p, c, head_dim, ws):
        norm(f"{p}.ln1", c)
        spec.append((f"{p}.msa.relative_position_params", (c // head_dim, 2 * ws - 1, 2 * ws - 1),
                     "tcm_relpos"))
        linear(f"{p}.msa.embedding_layer", c, 3 * c)
        linear(f"{p}.msa.linear", c, c)
        norm(f"{p}.ln2", c)
        linear(f"{p}.mlp.0", c, MLP_RATIO * c)
        linear(f"{p}.mlp.2", MLP_RATIO * c, c)

    def ctb(p, n, head_dim, ws):
        block(f"{p}.trans_block", n, head_dim, ws)
        conv_(f"{p}.conv1_1", 2 * n, 2 * n, 1)
        conv_(f"{p}.conv1_2", 2 * n, 2 * n, 1)
        conv_(f"{p}.conv_block.conv1", n, n, 3)
        conv_(f"{p}.conv_block.conv2", n, n, 3)

    def res_stride(p, cin, cout):
        conv_(f"{p}.conv1", cin, cout, 3)
        conv_(f"{p}.conv2", cout, cout, 3)
        gdn_(f"{p}.gdn", cout)
        conv_(f"{p}.skip", cin, cout, 1)

    def res_up(p, cin, cout):
        conv_(f"{p}.subpel_conv.0", cin, 4 * cout, 3)
        conv_(f"{p}.conv", cout, cout, 3)
        gdn_(f"{p}.igdn", cout)
        conv_(f"{p}.upsample.0", cin, 4 * cout, 3)

    def unit(p, c):
        conv_(f"{p}.conv.0", c, c // 2, 1)
        conv_(f"{p}.conv.2", c // 2, c // 2, 3)
        conv_(f"{p}.conv.4", c // 2, c, 1)

    def swatten(p, cin):
        a = ATTEN_DIM
        for r in range(3):
            unit(f"{p}.conv_a.{r}", a)
        for r in range(3):
            unit(f"{p}.conv_b.{r}", a)
        conv_(f"{p}.conv_b.3", a, a, 1)
        block(f"{p}.non_local_block.block_1", a, ATTEN_HEAD_DIM, WINDOW)
        block(f"{p}.non_local_block.block_2", a, ATTEN_HEAD_DIM, WINDOW)
        conv_(f"{p}.in_conv", cin, a, 1)
        conv_(f"{p}.out_conv", a, cin, 1)

    n, m, dc, d = cfg.width, cfg.M, cfg.dc, 2 * cfg.width
    res_stride("g_a.0", 3, d)
    k = 1
    for s in range(3):
        for _ in range(DEPTHS[s]):
            ctb(f"g_a.{k}", n, HEAD_DIM[s], WINDOW)
            k += 1
        if s < 2:
            res_stride(f"g_a.{k}", d, d)
        else:
            conv_(f"g_a.{k}", d, m, 3)
        k += 1
    res_up("g_s.0", m, d)
    k = 1
    for s in range(3, 6):
        for _ in range(DEPTHS[s]):
            ctb(f"g_s.{k}", n, HEAD_DIM[s], WINDOW)
            k += 1
        if s < 5:
            res_up(f"g_s.{k}", d, d)
        else:
            conv_(f"g_s.{k}.0", d, 3 * 4, 3)
        k += 1
    res_stride("h_a.0", m, d)
    for j in range(DEPTHS[0]):
        ctb(f"h_a.{1 + j}", n, HYPER_HEAD_DIM, HYPER_WINDOW)
    conv_(f"h_a.{1 + DEPTHS[0]}", d, Z_CHANNELS, 3)
    for h in ("h_mean_s", "h_scale_s"):
        res_up(f"{h}.0", Z_CHANNELS, d)
        for j in range(DEPTHS[3]):
            ctb(f"{h}.{1 + j}", n, HYPER_HEAD_DIM, HYPER_WINDOW)
        conv_(f"{h}.{1 + DEPTHS[3]}.0", d, 4 * m, 3)
    cins = [m + dc * min(i, cfg.max_support) for i in range(cfg.num_slices)]
    for bank in ("atten_mean", "atten_scale"):
        for i, cin in enumerate(cins):
            swatten(f"{bank}.{i}.0", cin)
    for bank, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0), ("lrp_transforms", dc)):
        for i, cin in enumerate(cins):
            c = cin + extra
            for j, w in enumerate((224, 128, dc)):
                conv_(f"{bank}.{i}.{2 * j}", c, w, 3)
                c = w
    eb, z = "entropy_bottleneck", Z_CHANNELS
    for i in range(5):
        spec.append((f"{eb}._matrix{i}", (z, EB_FILTERS[i + 1], EB_FILTERS[i]), "eb_matrix"))
        spec.append((f"{eb}._bias{i}", (z, EB_FILTERS[i + 1], 1), "eb_bias"))
        if i < 4:
            spec.append((f"{eb}._factor{i}", (z, EB_FILTERS[i + 1], 1), "eb_factor"))
    spec.append((f"{eb}.quantiles", (z, 1, 3), "eb_quantiles"))
    return spec


# ---------------------------------------------------------------------------
# layers (convolutions NCHW, the Transformer half (B, H, W, C))
# ---------------------------------------------------------------------------


def leaky(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def layer_norm(P, p, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{p}.weight"], P[f"{p}.bias"], LN_EPS)


def subpel(P, p, x):
    return F.pixel_shuffle(conv(P, f"{p}.0", x), 2)


def residual_block(P, p, x):
    """CompressAI's ResidualBlock with as many channels out as in."""
    out = leaky(conv(P, f"{p}.conv1", x))
    out = leaky(conv(P, f"{p}.conv2", out))
    return out + x


def res_stride(P, p, x):
    """CompressAI's ResidualBlockWithStride, stride 2."""
    out = leaky(conv(P, f"{p}.conv1", x, 2))
    out = gdn(P, f"{p}.gdn", conv(P, f"{p}.conv2", out))
    return out + conv(P, f"{p}.skip", x, 2)


def res_up(P, p, x):
    """CompressAI's ResidualBlockUpsample, factor 2."""
    out = leaky(subpel(P, f"{p}.subpel_conv", x))
    out = gdn(P, f"{p}.igdn", conv(P, f"{p}.conv", out), inverse=True)
    return out + subpel(P, f"{p}.upsample", x)


def shifted_mask(h: int, w: int, ws: int, device) -> torch.Tensor:
    """(1, 1, nW, ws^2, ws^2), True where a shifted window joins tokens of
    different regions: TCM's `generate_mask`, which marks the last row and
    column of windows, is Swin's region mask."""
    m = region_mask(h, w, ws, ws // 2) != 0
    return torch.as_tensor(m, device=device)[None, None]


def wmsa(P, p, x, head_dim: int, ws: int, shifted: bool):
    """SCUNet's WMSA on x (B, H, W, C) -> (B, H, W, C)."""
    b, h, w, c = x.shape
    heads, n, nw = c // head_dim, ws * ws, (h // ws) * (w // ws)
    if shifted:
        x = torch.roll(x, shifts=(-(ws // 2), -(ws // 2)), dims=(1, 2))
    xw = window_partition(x, ws).reshape(b, nw, n, c)
    qkv = F.linear(xw, P[f"{p}.embedding_layer.weight"], P[f"{p}.embedding_layer.bias"])
    q, k, v = qkv.reshape(b, nw, n, 3 * heads, head_dim).permute(3, 0, 1, 2, 4).chunk(3, dim=0)
    sim = torch.matmul(q, k.transpose(-2, -1)) * head_dim**-0.5
    idx = torch.as_tensor(rel_pos_index(ws), device=x.device)
    rel = P[f"{p}.relative_position_params"].reshape(heads, -1)[:, idx].reshape(heads, n, n)
    sim = sim + rel[:, None, None]
    if shifted:
        sim = sim.masked_fill(shifted_mask(h, w, ws, x.device), float("-inf"))
    out = torch.matmul(torch.softmax(sim, dim=-1), v)
    out = out.permute(1, 2, 3, 0, 4).reshape(b, nw, n, c)
    out = F.linear(out, P[f"{p}.linear.weight"], P[f"{p}.linear.bias"])
    out = window_reverse(out.reshape(b * nw, n, c), ws, h, w)
    if shifted:
        out = torch.roll(out, shifts=(ws // 2, ws // 2), dims=(1, 2))
    return out


def block(P, p, x, head_dim: int, ws: int, shifted: bool):
    """TCM's (Swin) Block on x (B, H, W, C)."""
    x = x + wmsa(P, f"{p}.msa", layer_norm(P, f"{p}.ln1", x), head_dim, ws, shifted)
    hid = F.gelu(F.linear(layer_norm(P, f"{p}.ln2", x), P[f"{p}.mlp.0.weight"], P[f"{p}.mlp.0.bias"]))
    return x + F.linear(hid, P[f"{p}.mlp.2.weight"], P[f"{p}.mlp.2.bias"])


def conv_trans_block(P, p, x, head_dim: int, ws: int, shifted: bool):
    """ConvTransBlock on x (B, 2N, H, W)."""
    half = x.shape[1] // 2
    conv_x, trans_x = torch.split(conv(P, f"{p}.conv1_1", x), (half, half), dim=1)
    conv_x = residual_block(P, f"{p}.conv_block", conv_x) + conv_x
    trans_x = block(P, f"{p}.trans_block", trans_x.permute(0, 2, 3, 1), head_dim, ws, shifted)
    return x + conv(P, f"{p}.conv1_2", torch.cat((conv_x, trans_x.permute(0, 3, 1, 2)), dim=1))


def attention_unit(P, p, x):
    """The residual unit of CompressAI's AttentionBlock (ReLU)."""
    out = F.relu(conv(P, f"{p}.conv.0", x))
    out = F.relu(conv(P, f"{p}.conv.2", out))
    return F.relu(conv(P, f"{p}.conv.4", out) + x)


def swatten(P, p, x):
    """SWAtten (inter_dim 128) on x (B, C, H, W)."""
    x = conv(P, f"{p}.in_conv", x)
    t = x.permute(0, 2, 3, 1)
    t = block(P, f"{p}.non_local_block.block_1", t, ATTEN_HEAD_DIM, WINDOW, False)
    t = block(P, f"{p}.non_local_block.block_2", t, ATTEN_HEAD_DIM, WINDOW, True)
    z = t.permute(0, 3, 1, 2)
    a = x
    for r in range(3):
        a = attention_unit(P, f"{p}.conv_a.{r}", a)
    bb = z
    for r in range(3):
        bb = attention_unit(P, f"{p}.conv_b.{r}", bb)
    bb = conv(P, f"{p}.conv_b.3", bb)
    return conv(P, f"{p}.out_conv", a * torch.sigmoid(bb) + x)


def stack3(P, p, x):
    x = F.gelu(conv(P, f"{p}.0", x))
    x = F.gelu(conv(P, f"{p}.2", x))
    return conv(P, f"{p}.4", x)


# ---------------------------------------------------------------------------
# the transforms (NCHW)
# ---------------------------------------------------------------------------


def _stages(P, prefix, x, stages, resample, last):
    """CTB stages: `DEPTHS[s]` blocks of head width `HEAD_DIM[s]`, W then SW,
    each followed by `resample`, the last by `last`."""
    k = 1
    for s in stages:
        for j in range(DEPTHS[s]):
            x = conv_trans_block(P, f"{prefix}.{k}", x, HEAD_DIM[s], WINDOW, j % 2 == 1)
            k += 1
        x = (last if s == stages[-1] else resample)(P, f"{prefix}.{k}", x)
        k += 1
    return x


def g_a(P, cfg, x):
    """x NCHW (B, 3, H, W) -> y NCHW (B, M, H/16, W/16)."""
    x = res_stride(P, "g_a.0", x)
    return _stages(P, "g_a", x, (0, 1, 2), res_stride, lambda P, p, t: conv(P, p, t, 2))


def g_s(P, cfg, y):
    """y NCHW (B, M, h, w) -> x_hat NCHW (B, 3, 16h, 16w), not clipped."""
    x = res_up(P, "g_s.0", y)
    return _stages(P, "g_s", x, (3, 4, 5), res_up, subpel)


def h_a(P, cfg, y):
    x = res_stride(P, "h_a.0", y)
    for j in range(DEPTHS[0]):
        x = conv_trans_block(P, f"h_a.{1 + j}", x, HYPER_HEAD_DIM, HYPER_WINDOW, j % 2 == 1)
    return conv(P, f"h_a.{1 + DEPTHS[0]}", x, 2)


def h_s(P, cfg, which, z_hat):
    x = res_up(P, f"{which}.0", z_hat)
    for j in range(DEPTHS[3]):
        x = conv_trans_block(P, f"{which}.{1 + j}", x, HYPER_HEAD_DIM, HYPER_WINDOW, j % 2 == 1)
    return subpel(P, f"{which}.{1 + DEPTHS[3]}", x)


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
        mean_support = swatten(P, f"atten_mean.{i}.0", torch.cat([lm] + support, dim=1))
        mu = stack3(P, f"cc_mean_transforms.{i}", mean_support)
        scale_support = swatten(P, f"atten_scale.{i}.0", torch.cat([ls] + support, dim=1))
        scale = stack3(P, f"cc_scale_transforms.{i}", scale_support)
        sym = torch.round(y_slices[i] - mu)
        stages.append((lhwc(sym), lhwc(build_indexes(scale, table32) + row0),
                       torch.ones_like(lhwc(sym), dtype=torch.bool)))
        y0 = sym + mu
        lrp = stack3(P, f"lrp_transforms.{i}", torch.cat([mean_support, y0], dim=1))
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
    """Symbols per stage: z (192 channels) at 1/64, then every slice at 1/16."""
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
