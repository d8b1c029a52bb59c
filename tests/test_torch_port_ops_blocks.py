"""PyTorch port vs the JAX package: ops, blocks, transforms and model fragments.

Inputs come from numpy with a fixed seed and go through both sides.  The
TINY model's weights are drawn by the port's `init_params`, carried into
the JAX tree by the JAX package's `import_progressive`, and back into the
port by `from_jax_params`.  Float32 throughout; bound max|d| <= 2e-4 (the
bound of tests/test_full_model_parity.py), gradients of `lower_bound` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.layers import blocks as jblocks
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive
from progressivecodec_tpu.ops import conv as jconv
from progressivecodec_tpu.ops import math as jmath

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.layers import blocks
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.ops import conv, deconv_cuda, math as tmath
from progressivecodec_tpu_torch.utils import profiling

TOL = 2e-4
F32 = torch.float32
TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_ste_round_forward_and_identity_grad(seed):
    x = np.random.default_rng(seed).normal(0, 3, (64,)).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 2.5]  # half-to-even ties
    xt = _t(x).requires_grad_(True)
    y = tmath.ste_round(xt)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jmath.ste_round(jnp.asarray(x))))
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


@pytest.mark.parametrize("bound", [0.0, 0.11, 1.0])
def test_lower_bound_forward_and_grads_equal_jax(bound):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (256,)).astype(np.float32)
    g = rng.normal(0, 1, (256,)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: jmath.lower_bound(v, bound), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    y_t = tmath.lower_bound(xt, bound)
    y_t.backward(_t(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_j))


def test_nonneg_reparam_and_init_match_jax():
    x = np.random.default_rng(4).normal(0, 1, (8, 8)).astype(np.float32)
    _close(tmath.nonneg_reparam(_t(x), 1e-6).numpy(), jmath.nonneg_reparam(jnp.asarray(x), 1e-6), 0)
    _close(tmath.nonneg_init(_t(x)).numpy(), jmath.nonneg_init(jnp.asarray(x)), 0)
    assert tmath.PEDESTAL == jmath.PEDESTAL


@pytest.mark.parametrize("k,stride", [(5, 2), (3, 1), (3, 2), (1, 1)])
def test_conv2d_geometry_matches_jax(k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(0, 1, (2, 13, 10, 5)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, 5, 7)).astype(np.float32)
    b = rng.normal(0, 1, (7,)).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    out = conv.conv2d(_t(x).permute(0, 3, 1, 2), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride)
    _close(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("k,stride", [(5, 2), (3, 2)])
def test_deconv2d_geometry_matches_jax(k, stride):
    rng = np.random.default_rng(7 + k)
    x = rng.normal(0, 1, (1, 6, 5, 4)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, 4, 3)).astype(np.float32)
    b = rng.normal(0, 1, (3,)).astype(np.float32)
    ref = jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    out = conv.deconv2d(_t(x).permute(0, 3, 1, 2), _t(w.transpose(2, 3, 0, 1)), _t(b), stride=stride)
    _close(out.permute(0, 2, 3, 1).numpy(), ref)


def test_pixel_shuffle_matches_jax_channel_order():
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    ref = jconv.pixel_shuffle(jnp.asarray(x), 2)
    out = conv.pixel_shuffle(_t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# g_s's transposed convolution: the card kernel's tap table and weight packing
# ---------------------------------------------------------------------------

# g_s's four layers (B, Cin, Cout, H, W) at a 4x6 latent, and ragged sizes:
# maps that no tile divides, Cin not a multiple of the kernel's 8-channel
# stage, Cout not a multiple of its channel tile
GS_DECONV_SHAPES = [(1, 320, 192, 4, 6), (1, 192, 192, 8, 12), (1, 192, 192, 16, 24),
                    (1, 192, 3, 32, 48)]
RAGGED_DECONV_SHAPES = [(1, 20, 16, 5, 7), (2, 9, 3, 33, 17), (1, 13, 40, 17, 33), (3, 5, 2, 1, 1)]


def test_subpixel_taps_cover_each_tap_once_by_the_transposed_index_rule():
    taps = deconv_cuda.subpixel_taps()
    assert {p: len(t) for p, t in taps.items()} == {(0, 0): 9, (0, 1): 6, (1, 0): 6, (1, 1): 4}
    assert sorted((ky, kx) for t in taps.values() for *_, ky, kx in t) == [
        (ky, kx) for ky in range(5) for kx in range(5)]
    for (a, b), t in taps.items():
        assert list(t) == sorted(t)  # dy, then dx, ascending: the kernel's order
        for dy, dx, ky, kx in t:
            # input i+dy reaches output 2(i+dy) - padding + ky = 2i + a
            assert (2 * dy - 2 + ky, 2 * dx - 2 + kx) == (a, b)


def test_pack_weight_puts_each_taps_channels_together():
    w = torch.randn((7, 5, 5, 5), generator=torch.Generator().manual_seed(0))
    wp = deconv_cuda.pack_weight(w, 8)
    assert wp.shape == (7, 25, 8) and wp.is_contiguous()
    for ky in range(5):
        for kx in range(5):
            assert torch.equal(wp[:, ky * 5 + kx, :5], w[:, :, ky, kx])
    assert not wp[:, :, 5:].any()


@pytest.mark.parametrize("shape", GS_DECONV_SHAPES + RAGGED_DECONV_SHAPES)
def test_four_stride_1_convolutions_rebuild_the_transposed_convolution(shape):
    b, cin, cout, h, w = shape
    rng = np.random.default_rng(sum(shape))
    x = _t(rng.normal(0, 1, (b, cin, h, w)))
    wt = _t(rng.normal(0, 1 / (5 * cin ** 0.5), (cin, cout, 5, 5)))
    bias = _t(rng.normal(0, 1, (cout,)))
    want = torch.nn.functional.conv_transpose2d(x, wt, bias, stride=2, padding=2, output_padding=1)
    got = deconv_cuda.deconv2d_subpixel(x, wt, bias)
    assert got.shape == want.shape == (b, cout, 2 * h, 2 * w)
    # the same products in another order
    assert float((got - want).norm() / want.norm()) <= 1e-6


def test_cpu_and_autograd_deconvs_launch_nothing():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(0, 1, (2, 8, 5, 6)))
    layer = blocks.Deconv(8, 16, device="cpu")
    want = torch.nn.functional.conv_transpose2d(x, layer.weight, layer.bias, stride=2, padding=2,
                                                output_padding=1)
    n0, f0 = profiling.total("launch:deconv2d"), profiling.total("fallback:deconv2d")
    with torch.no_grad():
        assert torch.equal(layer(x), want)
    y = layer(x.requires_grad_(True))
    y.sum().backward()
    assert torch.equal(y.detach(), want) and x.grad is not None
    # the CPU's F.conv_transpose2d is the plain path, not a fallback
    assert (profiling.total("launch:deconv2d"), profiling.total("fallback:deconv2d")) == (n0, f0)


class _PassThrough(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def test_autograd_and_dispatch_modes_see_the_deconv_as_aten():
    """Only autograd and FlopCounterMode take a CUDA deconv off the kernel:
    any other dispatch mode leaves it there."""
    from torch.utils.flop_counter import FlopCounterMode

    x, w = torch.zeros((1, 2, 3, 3)), torch.zeros((2, 2, 5, 5), requires_grad=True)
    assert conv._aten_only(x, w, None)
    with torch.no_grad():
        assert not conv._aten_only(x, w, None)
        with _PassThrough():
            assert not conv._aten_only(x, w, None)
        with FlopCounterMode(display=False):
            assert conv._aten_only(x, w, None)
            with _PassThrough():
                assert conv._aten_only(x, w, None)


def test_deconv_plan_by_channels_and_the_first_layer_fills_the_card():
    assert [deconv_cuda.plan(c) for c in (1, 3, 4, 32, 192)] == ["narrow"] * 2 + ["wide"] * 3
    # g_s's first layer at 768x512 (a 32x48 latent, 192 channels) on 132 SMs
    assert deconv_cuda.grid_ctas("wide", 1, 192, 32, 48) >= 132
    assert deconv_cuda.macs(1, 320, 192, 32, 48) == 2_359_296_000
    with pytest.raises(ValueError):
        deconv_cuda.deconv2d_s2k5(torch.zeros((1, 2, 3, 3)), torch.zeros((2, 2, 5, 5)))


@pytest.mark.parametrize("h,w", [(64, 64), (65, 100), (512, 768), (30, 1)])
def test_padding_helpers_match_jax(h, w):
    assert conv.compute_padding(h, w) == jconv.compute_padding(h, w)
    x = np.random.default_rng(h + w).random((1, h, w, 3)).astype(np.float32)
    xp_j, pads_j = jconv.pad_image(jnp.asarray(x))
    xp_t, pads_t = conv.pad_image(_t(x))
    assert pads_t == pads_j
    np.testing.assert_array_equal(xp_t.numpy(), np.asarray(xp_j))
    np.testing.assert_array_equal(conv.unpad_image(xp_t, pads_t).numpy(), x)


# ---------------------------------------------------------------------------
# blocks, standalone (flax params mapped by hand)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax(inverse):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 6, 5, 16)).astype(np.float32)
    mod = jblocks.GDN(inverse=inverse)
    p = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p = {"beta": p["beta"] + rng.uniform(0, 0.5, 16).astype(np.float32),
         "gamma": p["gamma"] + rng.uniform(0, 0.05, (16, 16)).astype(np.float32)}
    ref = mod.apply({"params": p}, jnp.asarray(x))
    g = blocks.GDN(16, inverse=inverse, device="cpu")
    g.load_state_dict({k: _t(v) for k, v in p.items()}, strict=True)
    with torch.no_grad():
        out = g(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("ws,shift,hw", [(4, 0, (8, 8)), (4, 2, (8, 12)), (8, 4, (16, 16))])
def test_window_attention_matches_jax(ws, shift, hw):
    rng = np.random.default_rng(ws + shift)
    c = 16
    x = rng.normal(0, 1, (2, *hw, c)).astype(np.float32)
    mod = jblocks.WinBasedAttention(num_heads=8, window_size=ws, shift_size=shift)
    p = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    p["qkv_bias"] = rng.normal(0, 0.1, p["qkv_bias"].shape).astype(np.float32)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    blk = blocks.WinBasedAttention(c, 8, ws, shift, device="cpu")
    blk.load_state_dict({
        "attn.qkv.weight": _t(p["qkv_kernel"].T), "attn.qkv.bias": _t(p["qkv_bias"]),
        "attn.proj.weight": _t(p["proj_kernel"].T), "attn.proj.bias": _t(p["proj_bias"]),
        "attn.relative_position_bias_table": _t(p["rel_pos_bias"]),
    }, strict=True)
    with torch.no_grad():
        out = blk(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(out.numpy(), ref)


def test_shift_mask_and_rel_index_tables_equal_jax():
    np.testing.assert_array_equal(blocks._rel_pos_index(8, 8), jblocks._rel_pos_index(8, 8))
    np.testing.assert_array_equal(
        blocks._shift_attn_mask(16, 24, 8, 4), jblocks._shift_attn_mask(16, 24, 8, 4)
    )


# ---------------------------------------------------------------------------
# the TINY model: transforms and codec fragments, JAX weights in the port
# ---------------------------------------------------------------------------


def _build_pair(multiple_decoder):
    kw = dict(TINY_KW, multiple_decoder=multiple_decoder)
    cfg = ModelConfig(**kw, scale_table=ScaleTableConfig(levels=32))
    jcfg = JaxModelConfig(**kw, scale_table=JaxScaleTableConfig(levels=32))
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = ChannelProgressiveWACNN(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return model.eval(), JaxModel(cfg=jcfg), {"params": params}, cfg


@pytest.fixture(scope="module")
def pair():
    return _build_pair(True)


@pytest.fixture(scope="module")
def pair_single_decoder():
    return _build_pair(False)


def _jax(jm, v, method, *args):
    """Jitted JAX method; python scalars and None stay static."""
    static = {i: a for i, a in enumerate(args) if a is None or isinstance(a, (int, float, str))}
    arrays = [a for i, a in enumerate(args) if i not in static]

    def fn(v, *arrs):
        it = iter(arrs)
        full = [static[i] if i in static else next(it) for i in range(len(args))]
        return jm.apply(v, *full, method=getattr(JaxModel, method))

    return jax.tree.map(np.asarray, jax.jit(fn)(v, *arrays))


def _port(m, method, *args):
    with torch.no_grad():
        out = getattr(m, method)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args])
    return jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, out)


def test_analyze_matches_jax(pair):
    m, jm, v, _ = pair
    x = np.random.default_rng(21).random((2, 64, 64, 3)).astype(np.float32)
    _close(_port(m, "analyze", x), _jax(jm, v, "analyze", jnp.asarray(x)))


def test_hyper_enc_and_dec_match_jax(pair):
    m, jm, v, cfg = pair
    rng = np.random.default_rng(22)
    y = rng.normal(0, 1, (1, 8, 8, cfg.M)).astype(np.float32)
    _close(_port(m, "codec_hyper_enc", y), _jax(jm, v, "codec_hyper_enc", y))
    z = rng.normal(0, 2, (1, 2, 2, cfg.N)).astype(np.float32)
    for a, b in zip(_port(m, "codec_hyper_dec", z), _jax(jm, v, "codec_hyper_dec", z)):
        _close(a, b)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("decoders", ["dual", "single"])
def test_synthesis_matches_jax(pair, pair_single_decoder, which, decoders):
    m, jm, v, cfg = pair if decoders == "dual" else pair_single_decoder
    y = np.random.default_rng(23 + which).normal(0, 1, (1, 4, 4, cfg.division_channel))
    y = y.astype(np.float32)
    _close(_port(m, "codec_synth", which, y), _jax(jm, v, "codec_synth", which, y))


def test_base_fragments_match_jax(pair):
    m, jm, v, cfg = pair
    rng = np.random.default_rng(24)
    lm = rng.normal(0, 1, (1, 4, 4, cfg.division_dimension[1])).astype(np.float32)
    ls = rng.normal(0, 1, (1, 4, 4, cfg.division_dimension[1])).astype(np.float32)
    sup = [rng.normal(0, 1, (1, 4, 4, cfg.dim_chunk)).astype(np.float32) for _ in range(2)]
    table = cfg.scale_table.values().astype(np.float32)
    tp = _port(m, "codec_base_params", 2, lm, ls, tuple(_t(s) for s in sup), _t(table))
    tj = _jax(jm, v, "codec_base_params", 2, lm, ls, tuple(sup), table)
    for a, b in zip((tp[0], tp[1], tp[3]), (tj[0], tj[1], tj[3])):
        _close(a, b)
    vals = rng.integers(-3, 4, (16 * cfg.dim_chunk,)).astype(np.int32)
    rp = _port(m, "codec_base_recon", 2, tj[3], tj[0], torch.from_numpy(vals))
    _close(rp, _jax(jm, v, "codec_base_recon", 2, tj[3], tj[0], vals))


def test_prog_fragments_match_jax(pair):
    m, jm, v, cfg = pair
    rng = np.random.default_rng(25)
    d1, dc, s = cfg.division_dimension[1], cfg.dim_chunk, cfg.num_prog_slices
    lm = rng.normal(0, 1, (1, 4, 4, d1)).astype(np.float32)
    ls = rng.normal(0, 1, (1, 4, 4, d1)).astype(np.float32)
    base = [rng.normal(0, 1, (1, 4, 4, dc)).astype(np.float32) for _ in range(cfg.ns0)]
    table = cfg.scale_table.values().astype(np.float32)
    tp = _port(m, "codec_prog_stacked", 10.0, None, lm, ls, tuple(_t(b) for b in base), _t(table))
    tj = _jax(jm, v, "codec_prog_stacked", 10.0, None, lm, ls, tuple(base), table)
    for i in (0, 1, 5, 6):  # mu, scale, mean_support, base_stack
        _close(tp[i], tj[i])
    vals = rng.integers(-3, 4, (s * 16 * dc,)).astype(np.int32)
    keep = rng.random((s, 1, 4, 4, dc)) < 0.6
    args = (tj[5], tj[0])
    rp = _port(m, "codec_prog_recon_stacked", *args, torch.from_numpy(vals),
               torch.from_numpy(keep), _t(tj[6]))
    rj = _jax(jm, v, "codec_prog_recon_stacked", *args, vals, keep, tj[6])
    _close(rp, rj)
