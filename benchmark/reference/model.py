"""Plain PyTorch reference of the progressive codec's round trip.

The semantics of EIDOSLAB/ProgressiveCodec's ChannelProgressiveWACNN
(`src/compress/models/CHProg_cnn.py`) and its REM subclass
(`src/compress/models/CHProgREM.py`), written as functions of a state dict
named like the reference's module tree (`g_a.0.0.weight`, ...).  It imports
nothing of the program under test and takes nothing the program made: the
benchmark hands it the weights it drew and the images it made, and it
works out again every latent, mean, scale, mask, CDF index and symbol.

The order of the floating-point operations follows the published model
layer by layer (NCHW, one convolution per layer, the same concatenation
order), so that a program computing the same mathematics in float32 with
TF32 off reads (nearly) the same bits.  What the benchmark compares is
in `benchmark/compare.py`.

`reference_request` returns, for one request (a batch of images at one
quality), the coder's stages (symbols, CDF rows, keep flags) in the order
the container codes them, the latent the synthesis decodes (`y_hat`), and
the reconstruction (`x_hat`).  `stage_sizes` and `chain_flops` give the
container's stages and the round trip's FLOPs for the yardstick (the
interface every reference keeps is in `benchmark/reference/__init__.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.yardstick import _count

F32 = torch.float32
PEDESTAL = (2.0**-18) ** 2
SCALE_BOUND = 0.11
EB_FILTERS = (1, 3, 3, 3, 3, 1)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class Cfg:
    """The model fields the reference reads, from a configuration file's
    "model" object (the published defaults where a field is absent)."""

    def __init__(self, model: dict):
        self.name = model.get("name", "channel")
        self.N = int(model.get("N", 192))
        self.dc = int(model.get("dim_chunk", 32))
        self.d0, self.d1 = (int(v) for v in model.get("division_dimension", (320, 640)))
        self.max_support = int(model.get("max_support_slices", 5))
        self.check_levels = tuple(float(v) for v in model.get("check_levels", (0.01, 0.25, 1.75)))
        st = model.get("scale_table", {})
        self.scale_table = np.exp(np.linspace(np.log(st.get("min", 0.11)), np.log(st.get("max", 256.0)),
                                              int(st.get("levels", 64)))).astype("float64")
        for key, want in (("multiple_encoder", True), ("multiple_decoder", True),
                          ("multiple_hyperprior", False), ("mask_policy", "point-based-std"),
                          ("joiner_policy", "res"), ("support_progressive_slices", 0),
                          ("delta_encode", False), ("residual_before_lrp", False),
                          ("support_std", False), ("total_mu_rep", False),
                          ("all_scalable", False), ("u_net_post", 0), ("stack_prog", True)):
            if model.get(key, want) != want:
                raise NotImplementedError(f"the reference models {key}={want!r} only")
        if self.name not in ("channel", "rate"):
            raise NotImplementedError(f"model {self.name!r}")
        self.ns0 = self.d0 // self.dc
        self.ns1 = self.d1 // self.dc
        self.n_prog = self.ns1 - self.ns0
        # REM refines the enhancement slice by slice; the flagship codes its
        # independent enhancement slices as one stage
        self.stacked = self.name != "rate"
        self.base = "base_net." if self.name == "rate" else ""


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------


def param_spec(cfg: Cfg) -> list:
    """[(name, shape, kind)] of every weight of the model, kind one of conv,
    deconv, bias, linear, relpos, gdn_beta, gdn_gamma, eb_matrix, eb_bias,
    eb_factor, eb_quantiles, zero_out, zero_out_bias."""
    spec: list = []
    b = cfg.base

    def conv(p, cin, cout, k):
        spec.append((f"{p}.weight", (cout, cin, k, k), "conv"))
        spec.append((f"{p}.bias", (cout,), "bias"))

    def deconv(p, cin, cout, k):
        spec.append((f"{p}.weight", (cin, cout, k, k), "deconv"))
        spec.append((f"{p}.bias", (cout,), "bias"))

    def gdn(p, c):
        spec.append((f"{p}.beta", (c,), "gdn_beta"))
        spec.append((f"{p}.gamma", (c, c), "gdn_gamma"))

    def ru(p, n):
        conv(f"{p}.conv.0", n, n // 2, 1)
        conv(f"{p}.conv.2", n // 2, n // 2, 3)
        conv(f"{p}.conv.4", n // 2, n, 1)

    def attn(p, n, ws):
        for r in range(3):
            ru(f"{p}.conv_a.{r}", n)
        a = f"{p}.conv_b.0.attn"
        spec.append((f"{a}.qkv.weight", (3 * n, n), "linear"))
        spec.append((f"{a}.qkv.bias", (3 * n,), "bias"))
        spec.append((f"{a}.proj.weight", (n, n), "linear"))
        spec.append((f"{a}.proj.bias", (n,), "bias"))
        spec.append((f"{a}.relative_position_bias_table", ((2 * ws - 1) ** 2, 8), "relpos"))
        for r in range(3):
            ru(f"{p}.conv_b.{r + 1}", n)
        conv(f"{p}.conv_b.4", n, n, 1)

    def stack5(p, cin, out):
        c = cin
        for j, w in enumerate((224, 176, 128, 64, out)):
            conv(f"{p}.{2 * j}", c, w, 3)
            c = w

    n, d0, d1, dc = cfg.N, cfg.d0, cfg.d1, cfg.dc
    for e in range(2):
        p = f"{b}g_a.{e}"
        conv(f"{p}.0", 3, n, 5)
        gdn(f"{p}.1", n)
        conv(f"{p}.2", n, n, 5)
        gdn(f"{p}.3", n)
        attn(f"{p}.4", n, 8)
        conv(f"{p}.5", n, n, 5)
        gdn(f"{p}.6", n)
        conv(f"{p}.7", n, d0, 5)
        attn(f"{p}.8", d0, 4)
    for e in range(2):
        p = f"{b}g_s.{e}"
        attn(f"{p}.0", d0, 4)
        deconv(f"{p}.1", d0, n, 5)
        gdn(f"{p}.2", n)
        deconv(f"{p}.3", n, n, 5)
        gdn(f"{p}.4", n)
        attn(f"{p}.5", n, 8)
        deconv(f"{p}.6", n, n, 5)
        gdn(f"{p}.7", n)
        deconv(f"{p}.8", n, 3, 5)
    c = 2 * d0
    for j, w in enumerate((320, 288, 256, 224, n)):
        conv(f"{b}h_a.{2 * j}", c, w, 3)
        c = w
    for h in ("h_mean_s", "h_scale_s"):
        conv(f"{b}{h}.0", n, 192, 3)
        conv(f"{b}{h}.2.0", 192, 224 * 4, 3)
        conv(f"{b}{h}.4", 224, 256, 3)
        conv(f"{b}{h}.6.0", 256, 288 * 4, 3)
        conv(f"{b}{h}.8", 288, d1, 3)
    base_in = [d0 + dc * min(i, cfg.max_support) for i in range(cfg.ns0)]
    for bank, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0), ("lrp_transforms", dc)):
        for i, cin in enumerate(base_in):
            stack5(f"{b}{bank}.{i}", cin + extra, dc)
    enh = d1 - d0
    for bank, extra in (("cc_mean_transforms_prog", dc), ("cc_scale_transforms_prog", dc),
                        ("lrp_transforms_prog", 2 * dc)):
        for i in range(cfg.n_prog if bank != "lrp_transforms_prog" or cfg.stacked else cfg.ns0):
            stack5(f"{b}{bank}.{i}", enh + extra, dc)
    eb = f"{b}entropy_bottleneck"
    for i in range(5):
        spec.append((f"{eb}._matrix{i}", (n, EB_FILTERS[i + 1], EB_FILTERS[i]), "eb_matrix"))
        spec.append((f"{eb}._bias{i}", (n, EB_FILTERS[i + 1], 1), "eb_bias"))
        if i < 4:
            spec.append((f"{eb}._factor{i}", (n, EB_FILTERS[i + 1], 1), "eb_factor"))
    spec.append((f"{eb}.quantiles", (n, 1, 3), "eb_quantiles"))
    if cfg.name == "rate":
        for k in range(len(cfg.check_levels)):
            for i in range(cfg.ns0):
                p = f"post_latent.{k}.{i}"
                for stack, cin, widths in (("enc_base_entropy_params", 2 * dc, [dc] * 3),
                                           ("enc_enh_entropy_params", dc, [dc] * 3),
                                           ("enc_base_rep", dc, [dc] * 3),
                                           ("enc", 3 * dc, [2 * dc] * 3 + [dc])):
                    for j, w in enumerate(widths):
                        conv(f"{p}.{stack}.{j}.conv1", cin, w, 3)
                        conv(f"{p}.{stack}.{j}.conv2", w, w, 3)
                        if cin != w:
                            conv(f"{p}.{stack}.{j}.skip", cin, w, 1)
                        cin = w
                spec.append((f"{p}.zero_out.weight", (dc, dc), "zero_out"))
                spec.append((f"{p}.zero_out.bias", (dc,), "zero_out_bias"))
    return spec


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv(P, p, x, stride=1):
    w = P[f"{p}.weight"]
    return F.conv2d(x, w, P[f"{p}.bias"], stride=stride, padding=w.shape[-1] // 2)


def deconv(P, p, x, stride=2):
    w = P[f"{p}.weight"]
    k = w.shape[-1]
    return F.conv_transpose2d(x, w, P[f"{p}.bias"], stride=stride, padding=k // 2,
                              output_padding=stride - 1)


def nonneg(x, minimum=0.0):
    """The non-negative reparametrisation of GDN's beta and gamma."""
    out = torch.clamp_min(x, (minimum + PEDESTAL) ** 0.5)
    return out * out - PEDESTAL


def gdn(P, p, x, inverse=False):
    beta = nonneg(P[f"{p}.beta"], 1e-6)
    gamma = nonneg(P[f"{p}.gamma"])
    c = gamma.shape[0]
    norm = F.conv2d(x * x, gamma.reshape(c, c, 1, 1), beta)
    return x * torch.sqrt(norm) if inverse else x * torch.rsqrt(norm)


def residual_unit(P, p, x):
    h = F.gelu(conv(P, f"{p}.conv.0", x))
    h = F.gelu(conv(P, f"{p}.conv.2", h))
    return F.gelu(x + conv(P, f"{p}.conv.4", h))


def rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).reshape(-1)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask between tokens of different regions of a shifted window."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, None)):
        for wsl in (slice(0, w - ws), slice(w - ws, w - shift), slice(w - shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def window_attention(P, p, x, heads, ws, shift):
    """Swin window attention with relative-position bias, plus the input."""
    b, c, h, w = x.shape
    nh, nw = h // ws, w // ws
    xs = x.permute(0, 2, 3, 1)
    if shift:
        xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
    xw = xs.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, ws * ws, c)
    n, hd = ws * ws, c // heads
    qkv = F.linear(xw, P[f"{p}.qkv.weight"], P[f"{p}.qkv.bias"])
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul(q * hd**-0.5, k.transpose(-2, -1))
    idx = torch.as_tensor(rel_pos_index(ws), device=x.device)
    rel = P[f"{p}.relative_position_bias_table"][idx]
    attn = attn + rel.reshape(n, n, heads).permute(2, 0, 1)[None]
    if shift:
        mask = torch.as_tensor(shift_mask(h, w, ws, shift), device=x.device)
        attn = attn.reshape(-1, nh * nw, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
    out = F.linear(out, P[f"{p}.proj.weight"], P[f"{p}.proj.bias"])
    out = out.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return x + out.permute(0, 3, 1, 2)


def attention_block(P, p, x, ws, shift):
    """x + conv_a(x) * sigmoid(conv_b(x)), conv_b led by window attention."""
    a = x
    for r in range(3):
        a = residual_unit(P, f"{p}.conv_a.{r}", a)
    bb = window_attention(P, f"{p}.conv_b.0.attn", x, 8, ws, shift)
    for r in range(3):
        bb = residual_unit(P, f"{p}.conv_b.{r + 1}", bb)
    bb = conv(P, f"{p}.conv_b.4", bb)
    return x + a * torch.sigmoid(bb)


def stack5(P, p, x):
    for j in range(4):
        x = F.gelu(conv(P, f"{p}.{2 * j}", x))
    return conv(P, f"{p}.8", x)


def residual_block(P, p, x):
    y = F.leaky_relu(conv(P, f"{p}.conv1", x), 0.01)
    y = F.leaky_relu(conv(P, f"{p}.conv2", y), 0.01)
    return y + (conv(P, f"{p}.skip", x) if f"{p}.skip.weight" in P else x)


# ---------------------------------------------------------------------------
# the transforms (NCHW)
# ---------------------------------------------------------------------------


def g_a(P, cfg, x):
    ys = []
    for e in range(2):
        p = f"{cfg.base}g_a.{e}"
        h = gdn(P, f"{p}.1", conv(P, f"{p}.0", x, 2))
        h = gdn(P, f"{p}.3", conv(P, f"{p}.2", h, 2))
        h = attention_block(P, f"{p}.4", h, 8, 4)
        h = gdn(P, f"{p}.6", conv(P, f"{p}.5", h, 2))
        ys.append(attention_block(P, f"{p}.8", conv(P, f"{p}.7", h, 2), 4, 2))
    return torch.cat(ys, dim=1)


def g_s(P, cfg, which, y):
    p = f"{cfg.base}g_s.{which}"
    h = deconv(P, f"{p}.1", attention_block(P, f"{p}.0", y, 4, 2))
    h = deconv(P, f"{p}.3", gdn(P, f"{p}.2", h, inverse=True))
    h = attention_block(P, f"{p}.5", gdn(P, f"{p}.4", h, inverse=True), 8, 4)
    h = deconv(P, f"{p}.6", h)
    return deconv(P, f"{p}.8", gdn(P, f"{p}.7", h, inverse=True))


def h_a(P, cfg, y):
    h = y
    for j in range(4):
        h = F.gelu(conv(P, f"{cfg.base}h_a.{2 * j}", h, 2 if j == 2 else 1))
    return conv(P, f"{cfg.base}h_a.8", h, 2)


def h_s(P, cfg, which, z_hat):
    p = f"{cfg.base}{which}"
    h = F.gelu(conv(P, f"{p}.0", z_hat))
    h = F.gelu(F.pixel_shuffle(conv(P, f"{p}.2.0", h), 2))
    h = F.gelu(conv(P, f"{p}.4", h))
    h = F.gelu(F.pixel_shuffle(conv(P, f"{p}.6.0", h), 2))
    return conv(P, f"{p}.8", h)


# ---------------------------------------------------------------------------
# entropy parameters, masks and indexes
# ---------------------------------------------------------------------------


def build_indexes(scale, table32):
    """CDF row of each element: (levels - 1) - #{s in table[:-1] : sigma <= s}."""
    s = torch.clamp_min(scale, SCALE_BOUND)
    count = (s[..., None] <= table32[:-1]).sum(dim=-1, dtype=torch.int32)
    return (table32.shape[0] - 1) - count


def row_quantile(flat, q: float):
    """Linear-interpolated quantile of each row, index and weights in float32
    (numpy's and JAX's `quantile(method="linear")`)."""
    n = flat.shape[1]
    srt = torch.sort(flat, dim=1).values
    qf = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(qf), np.ceil(qf)
    hw = qf - low
    lw = np.float32(1.0) - hw
    lo, hi = int(np.clip(low, 0, n - 1)), int(np.clip(high, 0, n - 1))
    w = lambda v: torch.tensor(v, dtype=F32, device=flat.device)  # noqa: E731
    return srt[:, lo] * w(lw) + srt[:, hi] * w(hw)


def sigma_mask(scale, rows: int, pr: float):
    """The point-based-std mask: per row (one image, or one slice of one
    image) keep the elements whose sigma reaches the (1 - pr/10) quantile."""
    if pr >= 10:
        return torch.ones_like(scale)
    if pr <= 0:
        return torch.zeros_like(scale)
    flat = scale.reshape(rows, -1)
    q = row_quantile(flat, 1.0 - min(pr, 10) * 0.1)
    return (flat >= q[:, None]).reshape(scale.shape).to(F32)


def _f32(v: float) -> float:
    return float(np.float32(v))


def rem_interval(q: float, levels) -> tuple:
    """(bank index, q_bar) of the checkpoint interval holding q, compared at
    float32 as the container holds q; None below the first level."""
    c = [_f32(v) for v in levels]
    qq = _f32(q)
    if qq <= c[0]:
        return None
    if qq <= c[1]:
        return 0, levels[0]
    if qq <= c[2]:
        return 1, levels[1]
    return 2, levels[2]


def rem_bank(P, p, anchor, params_base, scale, att):
    """LatentRateReduction: refines sigma of one enhancement slice (NCHW in,
    channel-last where the projection is applied)."""
    f_prog = scale
    for j in range(3):
        f_prog = residual_block(P, f"{p}.enc_enh_entropy_params.{j}", f_prog)
    f_lat = anchor
    for j in range(3):
        f_lat = residual_block(P, f"{p}.enc_base_rep.{j}", f_lat)
    f_base = params_base
    for j in range(3):
        f_base = residual_block(P, f"{p}.enc_base_entropy_params.{j}", f_base)
    h = torch.cat([f_lat, f_base, f_prog], dim=1)
    for j in range(4):
        h = residual_block(P, f"{p}.enc.{j}", h)
    out = F.linear(h.permute(0, 2, 3, 1).contiguous(), P[f"{p}.zero_out.weight"], P[f"{p}.zero_out.bias"])
    return scale + out.permute(0, 3, 1, 2).contiguous() * att


def lhwc(t):
    """NCHW -> channel-last, the order in which the container codes a stage.
    Every tensor a convolution reads stays contiguous NCHW: cuDNN picks its
    algorithm, and so the rounding, by the layout."""
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# one request
# ---------------------------------------------------------------------------


@torch.no_grad()
def reference_request(P, cfg: Cfg, x, quality: float, medians=None) -> dict:
    """x (B, H, W, 3) in [0, 1] at `quality` -> {"stages": [(symbols,
    rows, keep)] flat int32/int32/bool in coding order (rows of the merged
    table: bottleneck rows first, then the Gaussian rows), "y_hat" (the
    synthesis input, channel-last), "x_hat" (B, H, W, 3) clipped}."""
    b = cfg.base
    quality = _f32(quality)
    table32 = torch.as_tensor(cfg.scale_table.astype(np.float32), device=x.device)
    row0 = cfg.N
    xb = x.permute(0, 3, 1, 2).contiguous()
    y = g_a(P, cfg, xb)
    z = h_a(P, cfg, y)
    med = P[f"{b}entropy_bottleneck.quantiles"][:, 0, 1] if medians is None else medians
    z_sym = torch.round(z - med.reshape(1, -1, 1, 1))
    z_hat = z_sym + med.reshape(1, -1, 1, 1)
    lm, ls = h_s(P, cfg, "h_mean_s", z_hat), h_s(P, cfg, "h_scale_s", z_hat)
    zrows = torch.arange(cfg.N, dtype=torch.int32, device=x.device).reshape(1, -1, 1, 1).expand(z.shape)
    stages = [(lhwc(z_sym), lhwc(zrows), torch.ones_like(lhwc(z_sym), dtype=torch.bool))]

    dc, d0 = cfg.dc, cfg.d0
    y_slices = torch.split(y, dc, dim=1)
    y_hat_base, mu_base, scale_base = [], [], []
    for i in range(cfg.ns0):
        support = y_hat_base[: min(i, cfg.max_support)]
        mean_support = torch.cat([lm[:, :d0]] + support, dim=1)
        scale_support = torch.cat([ls[:, :d0]] + support, dim=1)
        mu = stack5(P, f"{b}cc_mean_transforms.{i}", mean_support)
        scale = stack5(P, f"{b}cc_scale_transforms.{i}", scale_support)
        sym = torch.round(y_slices[i] - mu)
        stages.append((lhwc(sym), lhwc(build_indexes(scale, table32) + row0),
                       torch.ones_like(lhwc(sym), dtype=torch.bool)))
        y0 = sym + mu
        lrp = stack5(P, f"{b}lrp_transforms.{i}", torch.cat([mean_support, y0], dim=1))
        y_hat_base.append(y0 + 0.5 * torch.tanh(lrp))
        mu_base.append(mu)
        scale_base.append(scale)

    if quality == 0:
        y_hat = torch.cat(y_hat_base, dim=1)
        x_hat = torch.clamp(g_s(P, cfg, 0, y_hat), 0.0, 1.0)
        return {"stages": _flat(stages), "y_hat": lhwc(y_hat), "x_hat": lhwc(x_hat)}

    lm_e, ls_e = lm[:, d0:], ls[:, d0:]
    bsz = x.shape[0]
    prog_hat, parts = [], []
    for i in range(cfg.n_prog):
        base = y_hat_base[i]
        mean_support = torch.cat([lm_e, base], dim=1)
        mu = stack5(P, f"{b}cc_mean_transforms_prog.{i}", mean_support)
        scale = stack5(P, f"{b}cc_scale_transforms_prog.{i}", torch.cat([ls_e, base], dim=1))
        if not cfg.stacked:
            iv = rem_interval(quality, cfg.check_levels)
            if iv is not None:
                k, q_bar = iv
                att = torch.round(sigma_mask(lhwc(scale), bsz, quality)
                                  - sigma_mask(lhwc(scale), bsz, q_bar)).permute(0, 3, 1, 2).contiguous()
                scale = rem_bank(P, f"post_latent.{k}.{i}", base,
                                 torch.cat([mu_base[i], scale_base[i]], dim=1), scale, att)
        parts.append((mean_support, mu, scale, base))
    if cfg.stacked:
        # the stacked bank ranks sigma per (slice, image)
        sc = torch.stack([lhwc(p[2]) for p in parts])
        masks = sigma_mask(sc, cfg.n_prog * bsz, quality)
        masks = [masks[i].permute(0, 3, 1, 2).contiguous() for i in range(cfg.n_prog)]
    else:
        masks = [sigma_mask(lhwc(p[2]), bsz, quality).permute(0, 3, 1, 2).contiguous() for p in parts]
    prog_stage = []
    for i, ((mean_support, mu, scale, base), mask) in enumerate(zip(parts, masks)):
        ys = y_slices[cfg.ns0 + i]
        sym = torch.round((ys - mu) * mask)
        keep = torch.round(mask) > 0.5
        prog_stage.append((lhwc(sym), lhwc(build_indexes(scale, table32) + row0), lhwc(keep)))
        y0 = torch.where(keep, sym, torch.zeros((), dtype=F32, device=x.device)) + mu
        lrp = stack5(P, f"{b}lrp_transforms_prog.{i}", torch.cat([mean_support, y0], dim=1))
        prog_hat.append(y0 + 0.5 * torch.tanh(lrp) + base)
    if cfg.stacked:
        # one stage: (slice, batch, h, w, channel) order
        stages.append(tuple(torch.stack([s[j] for s in prog_stage]) for j in range(3)))
    else:
        stages.extend(prog_stage)
    y_hat = torch.cat(prog_hat, dim=1)
    x_hat = torch.clamp(g_s(P, cfg, 1, y_hat), 0.0, 1.0)
    return {"stages": _flat(stages), "y_hat": lhwc(y_hat), "x_hat": lhwc(x_hat)}


def _flat(stages):
    return [(s.reshape(-1).to(torch.int32), r.reshape(-1).to(torch.int32), k.reshape(-1).to(torch.bool))
            for s, r, k in stages]


# ---------------------------------------------------------------------------
# the container's stages and the round trip's FLOPs
# ---------------------------------------------------------------------------


def stage_sizes(cfg: Cfg, batch: int, h: int, w: int, quality: float) -> list:
    """Symbols per stage of the container, in coding order: z at 1/64, the
    base slices at 1/16, then the enhancement as one stacked stage or one
    stage per slice."""
    hy, wy = h // 16, w // 16
    sizes = [batch * (hy // 4) * (wy // 4) * cfg.N] + [batch * hy * wy * cfg.dc] * cfg.ns0
    if quality > 0:
        sizes += [cfg.n_prog * batch * hy * wy * cfg.dc] if cfg.stacked else [batch * hy * wy * cfg.dc] * cfg.n_prog
    return sizes


def chain_flops(cfg: Cfg, batch: int, h: int, w: int, quality: float) -> int:
    """FLOPs (convolutions and products) one request needs: the encoder's
    analysis, hyper analysis and every entropy parameter, the decoder's
    entropy parameters, enhancement refinement and synthesis.  Counted over
    meta tensors: 2 x the forward, less the analysis and hyper analysis the
    decoder skips, less the enhancement refinement and synthesis the encoder
    skips."""
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, s, _ in param_spec(cfg)}
    x = torch.empty((batch, h, w, 3), device=meta)
    xb = torch.empty((batch, 3, h, w), device=meta)
    med = torch.empty((cfg.N,), device=meta)
    fwd = _count(lambda: reference_request(P, cfg, x, quality, medians=med))
    y = torch.empty((batch, 2 * cfg.d0, h // 16, w // 16), device=meta)
    ga = _count(lambda: g_a(P, cfg, xb))
    ha = _count(lambda: h_a(P, cfg, y))
    gs = _count(lambda: g_s(P, cfg, 1 if quality > 0 else 0, y[:, : cfg.d0]))
    lrp = 0
    if quality > 0:
        t = torch.empty((batch, cfg.d1 - cfg.d0 + 2 * cfg.dc, h // 16, w // 16), device=meta)
        lrp = cfg.n_prog * _count(lambda: stack5(P, f"{cfg.base}lrp_transforms_prog.0", t))
    return 2 * fwd - ga - ha - gs - lrp


def fan_std(shape, kind) -> float:
    """Kaiming-normal (fan_out) std of a convolution or deconvolution weight,
    lecun-normal std of a linear weight."""
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "deconv":
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    if kind == "linear":
        return math.sqrt(1.0 / shape[1]) / 0.87962566103423978
    raise ValueError(kind)
