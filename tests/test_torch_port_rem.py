"""PyTorch port vs the JAX package: REM, the rate-enhancement model ("rate").

At TINY (N=32, M=64, dim_chunk 8, division (32, 64), 64x64 images), on
weights from the port's `init_params` carried into the JAX tree by
`import_rem`, with every bank's `zero_out` projection filled with seeded
N(0, 0.1^2) values (at init it is zero and the banks are the identity, so
the banks would be tested for nothing):
  * `find_check_quality` and `_interval_index` equal JAX's on the
    checkpoint boundaries, for three, two and one checkpoint levels;
  * a LatentRateReduction bank agrees with JAX's within 2e-4, and so does
    the refinement hook with the non-default mu_std and dimension="middle";
  * `from_jax_params` equals JAX `export_rem`, which loads strictly, as do
    the port's own names; `init_params -> import_rem -> from_jax_params`
    gives back the same tensors;
  * `codec_prog_params` at q in {0.01, 0.25, 1.0, 10}, anchored on the base
    slices or on a checkpoint representation: mu and scale within 2e-4 of
    JAX's, mask, keep and idx exact;
  * `forward_single_quality` at q in {0, 5, 10}, with and without a
    checkpoint representation, within the forward tolerances of
    tests/test_torch_port_forward.py.
JAX runs eagerly: one jit of the TINY REM forward takes ~11 s on one CPU core,
an eager call ~3 s once its primitives are compiled.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models import rem as jax_rem
from progressivecodec_tpu.models.rem import PostRateProcessedNetwork as JaxREM
from progressivecodec_tpu.models.torch_import import export_rem, import_rem
from test_torch_port_variants import _close_or_equal, _j, image
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models import rem
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

TINY_KW = dict(name="rate", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))
QUALITIES = [0.01, 0.25, 1.0, 10.0]


def live_rem_weights(cfg, seed=0, std=0.1):
    """The port's seeded REM state dict with every zero_out weight drawn
    from N(0, std^2) (seed + 1), so each bank changes sigma."""
    sd = init_params(cfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.endswith("zero_out.weight"):
            sd[k] = std * torch.randn(sd[k].shape, generator=g, dtype=torch.float32)
    return sd


def build_rem(cfg=CFG, jcfg=JCFG, sd=None):
    """(port model on the CPU, JAX params) on the same weights."""
    sd = live_rem_weights(cfg) if sd is None else sd
    params = import_rem({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return model, params


def jax_apply(params, method, *args, **kw):
    """Eager JAX REM method on the same weights."""
    return JaxREM(cfg=JCFG).apply({"params": params}, *args, method=method, **kw)


@pytest.fixture(scope="module")
def setup():
    return build_rem()


@pytest.mark.parametrize("levels", [(0.01, 0.25, 1.75), (0.5, 2.0), (1.0,)])
@pytest.mark.parametrize("q", [0.0, 0.005, 0.01, 0.0100001, 0.1, 0.25, 0.2500001, 1.0, 1.75,
                               1.7500001, 5.0, 10.0])
def test_check_quality_intervals_match_jax(levels, q):
    assert rem.find_check_quality(q, levels) == jax_rem.find_check_quality(q, levels)
    assert rem._interval_index(q, levels) == jax_rem._interval_index(q, levels)


def test_check_quality_boundaries():
    cl = CFG.check_levels
    assert rem.find_check_quality(0.01, cl) == (0.0, 0.0)
    assert (rem.find_check_quality(0.25, cl), rem._interval_index(0.25, cl)) == ((0.01, 0.25), 0)
    assert (rem.find_check_quality(1.75, cl), rem._interval_index(1.75, cl)) == ((0.25, 1.75), 1)
    assert (rem.find_check_quality(10.0, cl), rem._interval_index(10.0, cl)) == ((1.75, 10.0), 2)
    assert rem.PostRateProcessedNetwork.init_qualities(CFG) == JaxREM.init_qualities(JCFG)


def test_latent_rate_reduction_matches_jax(setup):
    model, params = setup
    rng = np.random.default_rng(5)
    dc = CFG.dim_chunk
    x_base, params_base, params_enh = (rng.standard_normal((1, 4, 4, c)).astype(np.float32)
                                       for c in (dc, 2 * dc, dc))
    att = (rng.random((1, 4, 4, dc)) < 0.5).astype(np.float32)
    args = (x_base, params_base, params_enh, att)
    with torch.no_grad():
        ours = model.post_latent[1][2](*(torch.from_numpy(a) for a in args)).numpy()
    theirs = np.asarray(jax_rem.LatentRateReduction(dim_chunk=dc).apply(
        {"params": params["post_latent1_2"]}, *(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-4)
    # live: the bank moves sigma exactly where the attention mask is set
    moved = np.abs(ours - params_enh) > 0
    assert moved.any() and not moved[att == 0].any()


def test_mu_std_middle_refinement_matches_jax():
    """The options off the defaults: mu_std (the bank refines mu and sigma)
    and dimension="middle" (two blocks per input stack, three in enc), on
    seeded N(0, 0.05^2) weights for every parameter."""
    model = rem.PostRateProcessedNetwork(CFG, device="cpu", mu_std=True, dimension="middle")
    g = torch.Generator().manual_seed(7)
    sd = {k: 0.05 * torch.randn(v.shape, generator=g, dtype=torch.float32)
          for k, v in model.state_dict().items()}
    params = import_rem({k: v.numpy() for k, v in sd.items()}, JCFG, deep=False)
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    assert len(model.post_latent[0][0].enc) == 3
    rng = np.random.default_rng(8)
    dc = CFG.dim_chunk
    mu, scale, mu_b, scale_b, anchor = (rng.standard_normal((1, 4, 4, dc)).astype(np.float32)
                                        for _ in range(5))
    scale = np.abs(scale) + 0.2
    args = (mu, scale, mu_b, scale_b, anchor)
    with torch.no_grad():
        ours = model._refine_prog_params(2, 1.0, *(torch.from_numpy(a) for a in args),
                                         "point-based-std")
    theirs = JaxREM(cfg=JCFG, mu_std=True, dimension="middle").apply(
        {"params": params}, 2, 1.0, *(jnp.asarray(a) for a in args), False, "point-based-std",
        method=JaxREM._refine_prog_params)
    for a, b, before in zip(ours, theirs, (mu, scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-4)
        assert not np.array_equal(a.numpy(), before)


def test_rem_weights_map_like_export_rem(setup):
    model, params = setup
    ours, ref = from_jax_params(params, CFG), export_rem(params, JCFG)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    fresh = get_model(CFG, device="cpu")
    fresh.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}, strict=True)
    # the port's flat names load too
    flat = {k[len(rem.BASE_PREFIX):] if k.startswith(rem.BASE_PREFIX) else k: v
            for k, v in model.state_dict().items()}
    fresh.load_state_dict(flat, strict=True)
    sd = init_params(CFG, torch.Generator().manual_seed(3))
    back = from_jax_params(import_rem({k: v.numpy() for k, v in sd.items()}, JCFG), CFG)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    zero_out = [k for k in sd if "zero_out" in k]
    assert len(zero_out) == 2 * len(CFG.check_levels) * CFG.ns0
    assert all(not sd[k].any() for k in zero_out)


@pytest.mark.parametrize("anchored", [False, True], ids=["base_anchor", "checkpoint_anchor"])
@pytest.mark.parametrize("q", QUALITIES)
def test_rem_codec_prog_params_match_jax(setup, q, anchored, monkeypatch):
    """The port's enhancement fragments, recorded in a compress, replayed
    through JAX's."""
    model, params = setup
    x = torch.from_numpy(image(8))
    rep = None
    if anchored:
        rng = np.random.default_rng(9)
        rep = torch.from_numpy(rng.standard_normal((1, 4, 4, 4 * CFG.dim_chunk)).astype(np.float32))
    calls = []
    orig = model.codec_prog_params

    def spy(*args):
        out = orig(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(model, "codec_prog_params", spy)
    codec = make_codec(model, lanes=64, device="cpu")
    codec.compress(x, quality=q, checkpoint_rep=rep)
    monkeypatch.undo()
    assert len(calls) == CFG.num_prog_slices
    for args, out in calls:
        i, quality, mask_pol, *rest = args
        assert (rest[8] is not None) == anchored
        theirs = jax_apply(params, JaxREM.codec_prog_params, i, float(quality), mask_pol, *_j(rest))
        for k, (a, b, e) in enumerate(zip(out, theirs, (0, 0, 0, 1, 1, 1, 0))):
            _close_or_equal(f"slice {i} output {k}", a, b, e)


@pytest.fixture(scope="module")
def checkpoint_rep(setup):
    """A cascaded representation from the eval forward (the checkpoints)."""
    model, _ = setup
    return rem.extract_checkpoint_representation(model, torch.from_numpy(image(12)))


@pytest.mark.parametrize("anchored", [False, True], ids=["base_anchor", "checkpoint_anchor"])
@pytest.mark.parametrize("q", [0, 5, 10])
def test_rem_forward_single_quality_matches_jax(setup, checkpoint_rep, q, anchored):
    from test_torch_port_forward import check_forward

    model, params = setup
    rep = checkpoint_rep if anchored else None
    x = image(13)
    with torch.no_grad():
        ours = model.forward_single_quality(torch.from_numpy(x), q, checkpoint_rep=rep)
    theirs = jax_apply(params, JaxREM.forward_single_quality, jnp.asarray(x), q, training=False,
                       checkpoint_rep=_j(rep))
    check_forward(model, ours, theirs, q)


def test_extract_checkpoint_representation_matches_jax(setup, checkpoint_rep):
    model, params = setup
    assert checkpoint_rep.shape == (1, 4, 4, 4 * CFG.dim_chunk)
    theirs = jax_rem.extract_checkpoint_representation(
        JaxREM(cfg=JCFG), {"params": params}, jnp.asarray(image(12)))
    np.testing.assert_allclose(checkpoint_rep.numpy(), np.asarray(theirs), rtol=0, atol=2e-4)
    # with live banks the anchor changes the reconstruction
    x = torch.from_numpy(image(13))
    with torch.no_grad():
        plain = model.forward_single_quality(x, 1.0)["x_hat"]
        cascaded = model.forward_single_quality(x, 1.0, checkpoint_rep=checkpoint_rep)["x_hat"]
    assert (plain - cascaded).abs().max() > 0
