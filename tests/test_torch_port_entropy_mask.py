"""PyTorch port vs the JAX package: config, weights, entropy tables, indexes
and masks.

Bounds: CDF and coder tables byte-equal to the JAX `Codec.update()`;
`build_indexes` exact; masks exactly equal on the same sigma, ties
included; `from_jax_params` equal key for key and value for value to the
JAX `export_progressive`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu import config as jconfig
from progressivecodec_tpu.coder.rans_device import DeviceTables as JaxDeviceTables
from progressivecodec_tpu.entropy.gaussian import build_indexes as jax_build_indexes
from progressivecodec_tpu.layers import masking as jmasking
from progressivecodec_tpu.models.codec import Codec as JaxCodec
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import export_progressive, import_progressive

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch import config
from progressivecodec_tpu_torch.entropy.gaussian import build_indexes
from progressivecodec_tpu_torch.layers import masking
from progressivecodec_tpu_torch.models.codec import Codec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
QUALITIES = [0, 0.5, 2.5, 5, 7.5, 10]


def _cfgs(**kw):
    kw = dict(TINY_KW, **kw)
    return (config.ModelConfig(**kw, scale_table=config.ScaleTableConfig(levels=32)),
            jconfig.ModelConfig(**kw, scale_table=jconfig.ScaleTableConfig(levels=32)))


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = _cfgs()
    sd = init_params(cfg, torch.Generator().manual_seed(5))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = ChannelProgressiveWACNN(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return cfg, jcfg, model, params


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["ModelConfig", "ScaleTableConfig", "CoderConfig"])
def test_config_fields_and_defaults_match_jax(cls):
    ours, theirs = getattr(config, cls)(), getattr(jconfig, cls)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_json_reads_both_ways():
    cfg, jcfg = _cfgs(multiple_decoder=False, mask_policy="scalable_res")
    assert config.to_json(cfg) == jconfig.to_json(jcfg)
    assert config.model_config_from_json(jconfig.to_json(jcfg)) == cfg
    assert jconfig.model_config_from_json(config.to_json(cfg)) == jcfg
    np.testing.assert_array_equal(cfg.scale_table.values(), jcfg.scale_table.values())


@pytest.mark.parametrize("kw", [{}, dict(multiple_decoder=False), dict(multiple_hyperprior=True),
                                dict(multiple_encoder=False),
                                dict(stack_prog=False, multiple_encoder=False, u_net_post=2),
                                dict(mask_policy="three-levels-learnable", joiner_policy="cond"),
                                dict(division_dimension=(48, 64), support_progressive_slices=1)])
def test_from_jax_params_equals_export_progressive(kw):
    cfg, jcfg = _cfgs(**kw)
    sd = init_params(cfg, torch.Generator().manual_seed(1))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, jcfg)
    if cfg.stack_prog and "learnable" not in cfg.mask_policy and not cfg.support_progressive_slices:
        assert params["cc_mean_prog"]["conv0"]["kernel"].shape[0] == cfg.num_prog_slices
    else:  # unrolled banks; the lrp bank has ns0 entries
        assert len(params["lrp_prog"]) == cfg.ns0 and len(params["cc_mean_prog"]) == cfg.num_prog_slices
    ours, ref = from_jax_params(params, cfg), export_progressive(params, jcfg)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    model = ChannelProgressiveWACNN(cfg, device="meta")
    assert set(model.state_dict()) == set(ours)


def test_init_params_is_seeded_and_loads_strictly():
    cfg, _ = _cfgs()
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.float32 for v in a.values())
    ChannelProgressiveWACNN(cfg, device="cpu").load_state_dict(a, strict=True)
    q = a["entropy_bottleneck.quantiles"]
    assert torch.equal(q[:, 0], torch.tensor([-10.0, 0.0, 10.0]).expand(cfg.N, 3))


# ---------------------------------------------------------------------------
# entropy tables and indexes
# ---------------------------------------------------------------------------


def test_codec_update_tables_byte_equal_jax(tiny):
    cfg, jcfg, model, params = tiny
    ours = Codec(model, lanes=64)
    theirs = JaxCodec(JaxModel(cfg=jcfg), {"params": params}, lanes=64)
    t, jt = ours.update(), theirs.update()
    for name in ("cdf", "cdf_length", "offset", "max_symbol"):
        a, b = getattr(t, name), getattr(jt, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert t.inverse().tobytes() == jt.inverse().tobytes()
    assert ours.gauss_row0 == theirs.gauss_row0
    jd = JaxDeviceTables.from_tables(jt)
    d = ours.device_tables
    for name in ("enc_sf", "dec_sf"):
        np.testing.assert_array_equal(
            getattr(d, name).numpy().view(np.uint32), np.asarray(getattr(jd, name)), err_msg=name
        )
    for name in ("dec_val", "offset", "max_symbol"):
        np.testing.assert_array_equal(getattr(d, name).numpy(), np.asarray(getattr(jd, name)))
    assert d.lmax == jd.lmax


@pytest.mark.parametrize("levels", [32, 64])
def test_build_indexes_exact(levels):
    table = jconfig.ScaleTableConfig(levels=levels).values()
    t32 = table.astype(np.float32)
    rng = np.random.default_rng(levels)
    s = np.exp(rng.uniform(np.log(1e-3), np.log(400.0), (3, 5, 7, 8))).astype(np.float32)
    s.reshape(-1)[: levels] = t32  # exactly on the table
    s.reshape(-1)[levels : levels + 4] = [0.0, -1.0, 0.11, np.float32(0.11) - 1e-8]
    ref = np.asarray(jax_build_indexes(jnp.asarray(s), table, 0.11))
    out = build_indexes(torch.from_numpy(s), torch.from_numpy(t32), 0.11).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def _sigma(seed, shape, ties):
    rng = np.random.default_rng(seed)
    s = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    if ties:
        s = np.round(s * 2) / 2  # heavy ties on a half grid
    return s


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("ties", [False, True])
def test_stacked_point_based_std_mask_exact(q, ties):
    s = _sigma(int(q * 10), (4, 2, 6, 5, 8), ties)
    ref = np.asarray(jmasking.stacked_channel_mask(jnp.asarray(s), pr=q, dim_chunk=8,
                                                   division_channel=32))
    out = masking.stacked_channel_mask(torch.from_numpy(s), pr=q, dim_chunk=8,
                                       division_channel=32).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("policy,q", [("two-levels", 0), ("two-levels", 3), ("three-levels-std", 0),
                                      ("three-levels-std", 1), ("three-levels-std", 2),
                                      ("scalable_res", 0), ("scalable_res", 2.5),
                                      ("scalable_res", 5), ("scalable_res", 10)])
def test_stacked_policy_masks_exact(policy, q):
    s = _sigma(7, (4, 2, 6, 5, 8), True)
    kw = dict(pr=q, mask_pol=policy, dim_chunk=8, division_channel=32)
    ref = np.asarray(jmasking.stacked_channel_mask(jnp.asarray(s), **kw))
    np.testing.assert_array_equal(masking.stacked_channel_mask(torch.from_numpy(s), **kw).numpy(), ref)


@pytest.mark.parametrize("q", [0, 2.5, 10])
def test_stacked_cust_map_mask_exact(q):
    s = _sigma(8, (4, 1, 6, 5, 8), False)
    cm = _sigma(9, (4, 1, 6, 5, 8), True)
    ref = jmasking.stacked_channel_mask(jnp.asarray(s), pr=q, cust_map=jnp.asarray(cm))
    out = masking.stacked_channel_mask(torch.from_numpy(s), pr=q, cust_map=torch.from_numpy(cm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("policy", ["point-based-std", "three-levels-std", "scalable_res"])
def test_channel_mask_exact(q, policy):
    s = _sigma(11, (2, 6, 5, 8), True)
    for i in (0, 2):
        kw = dict(pr=q, mask_pol=policy, slice_index=i, dim_chunk=8, division_channel=32)
        ref = np.asarray(jmasking.channel_mask(jnp.asarray(s), **kw))
        out = masking.channel_mask(torch.from_numpy(s), **kw).numpy()
        np.testing.assert_array_equal(out, ref)


def test_quantile_matches_jax_on_large_rows():
    """Rows longer than 2^24 elements would make torch.quantile refuse; the
    port's sort-based quantile takes them (checked here on a 2^17 row)."""
    x = np.random.default_rng(12).normal(0, 1, (2, 1 << 17)).astype(np.float32)
    for q in (0.0, 0.25, 0.3, 0.95, 1.0):
        ref = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=1, method="linear"))
        np.testing.assert_array_equal(masking.row_quantile(torch.from_numpy(x), q).numpy(), ref)
