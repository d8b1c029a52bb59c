"""PyTorch port vs the JAX package: the single-quality eval forward and the
likelihoods it needs.

  * `gaussian_likelihood` and `gaussian_forward` (eval) on seeded inputs,
    and the entropy bottleneck's eval forward, against JAX's: rounded
    outputs exact, likelihoods within rtol 1e-3;
  * `forward_single_quality` at q in {0, 5, 10} for the stacked flagship
    layout, the reference CLI default (one decoder, unrolled enhancement)
    and WACNN (REM's is in tests/test_torch_port_rem.py), at TINY on the
    same weights: y_hat within 2e-4, likelihoods within rtol 1e-3 (the
    bounds of tests/test_full_model_parity.py), the enhancement mask exact,
    and x_hat within 2e-4 or 1e-5 of the synthesis's largest output before
    the clip, whichever is larger: with random weights that output reaches
    ~115 (the CLI default at q=10), and float32 noise ~2.6e-4;
  * `entropy_estimate_eval` on the stacked model at q in {0, 10}: bpp
    within 1% of JAX's, PSNR within 0.01 dB, the lambda loss within 1%;
  * training=True without a noise source is refused (the training
    forward is held to JAX's in tests/test_torch_port_train_step.py).
JAX runs eagerly (see tests/test_torch_port_rem.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.entropy.bottleneck import EntropyBottleneck as JaxBottleneck
from progressivecodec_tpu.entropy.gaussian import gaussian_forward as jax_gaussian_forward
from progressivecodec_tpu.entropy.gaussian import gaussian_likelihood as jax_gaussian_likelihood
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive, import_wacnn
from progressivecodec_tpu.models.wacnn import WACNN as JaxWACNN
from progressivecodec_tpu.training.evaluate import (
    entropy_estimate_eval as jax_entropy_estimate_eval,
)
from test_torch_port_variants import image
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck
from progressivecodec_tpu_torch.entropy.gaussian import gaussian_forward, gaussian_likelihood
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.transforms import nchw
from progressivecodec_tpu_torch.models.wacnn import WACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
MODELS = {
    "stacked": (dict(name="channel"), JaxModel, import_progressive),
    "unrolled_cli_default": (dict(name="channel", multiple_decoder=False, stack_prog=False),
                             JaxModel, import_progressive),
    "wacnn": (dict(name="cnn"), JaxWACNN, import_wacnn),
}


def synthesis_peak(model, y_hat, q) -> float:
    """The largest |x_hat| before the clip to [0, 1]."""
    y = nchw(y_hat)
    with torch.no_grad():
        if isinstance(model, WACNN):
            return float(model.g_s(y).abs().max())
        which = 0 if q == 0 else 1
        return float(model._apply_refine(model._synth_net(which)(y), which).abs().max())


def check_forward(model, ours: dict, theirs: dict, q) -> None:
    """The forward's outputs against JAX's: y_hat, mu and std within 2e-4,
    likelihoods within rtol 1e-3, masks exact; x_hat within 2e-4, or 1e-5
    of the synthesis's largest output before the clip where that is larger
    (random weights drive it past 100, where float32 noise is ~1e-4)."""
    peak = synthesis_peak(model, ours["y_hat"], q)
    for k in ("x_hat", "y_hat", "mu", "std", "mu_base", "std_base"):
        if k in theirs:
            atol = max(2e-4, 1e-5 * peak) if k == "x_hat" else 2e-4
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=0, atol=atol,
                                       err_msg=f"{k} at q={q}")
    for k in ("y", "z"):
        np.testing.assert_allclose(ours["likelihoods"][k].numpy(),
                                   np.asarray(theirs["likelihoods"][k]), rtol=1e-3, atol=0,
                                   err_msg=f"likelihood {k} at q={q}")
    if "mask" in theirs:
        np.testing.assert_array_equal(ours["mask"].numpy(), np.asarray(theirs["mask"]))
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(0)
    x = (4 * rng.standard_normal((2, 8, 8, 16))).astype(np.float32)
    scales = np.exp(rng.uniform(-4, 5, x.shape)).astype(np.float32)
    means = rng.standard_normal(x.shape).astype(np.float32)
    for m in (None, means):
        ours = gaussian_likelihood(torch.from_numpy(x), torch.from_numpy(scales),
                                   None if m is None else torch.from_numpy(m)).numpy()
        theirs = np.asarray(jax_gaussian_likelihood(jnp.asarray(x), jnp.asarray(scales),
                                                    None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=0)
        assert ours.min() >= 1e-9
        out, lik = gaussian_forward(torch.from_numpy(x), torch.from_numpy(scales),
                                    None if m is None else torch.from_numpy(m))
        j_out, j_lik = jax_gaussian_forward(jnp.asarray(x), jnp.asarray(scales),
                                            None if m is None else jnp.asarray(m), training=False)
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
        np.testing.assert_allclose(lik.numpy(), np.asarray(j_lik), rtol=1e-3, atol=0)
    with pytest.raises(ValueError, match="training=True requires a noise source"):
        gaussian_forward(torch.from_numpy(x), torch.from_numpy(scales), training=True)


def test_bottleneck_forward_matches_jax():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():  # trained-looking factors and quantiles
        g = torch.Generator().manual_seed(3)
        for i in range(4):
            getattr(eb, f"_factor{i}").normal_(0, 0.5, generator=g)
        eb.quantiles.add_(torch.randn(eb.quantiles.shape, generator=g))
    params = eb.host_params()
    z = (3 * np.random.default_rng(4).standard_normal((2, 4, 6, 16))).astype(np.float32)
    with torch.no_grad():
        out, lik = eb(torch.from_numpy(z))
    j_out, j_lik = JaxBottleneck(channels=16).apply({"params": params}, jnp.asarray(z),
                                                    training=False)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_allclose(lik.numpy(), np.asarray(j_lik), rtol=1e-3, atol=0)
    with pytest.raises(ValueError, match="training=True requires a noise source"):
        eb(torch.from_numpy(z), training=True)


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    kw, jax_cls, importer = MODELS[request.param]
    cfg = ModelConfig(**TINY_KW, **kw, scale_table=ScaleTableConfig(levels=32))
    jcfg = JaxModelConfig(**TINY_KW, **kw, scale_table=JaxScaleTableConfig(levels=32))
    sd = init_params(cfg, torch.Generator().manual_seed(21))
    params = importer({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return model, jax_cls(cfg=jcfg), params


@pytest.mark.parametrize("q", [0, 5, 10])
def test_forward_single_quality_matches_jax(model_pair, q):
    model, jmodel, params = model_pair
    x = image(22)
    with torch.no_grad():
        ours = model.forward_single_quality(torch.from_numpy(x), q)
    theirs = jmodel.apply({"params": params}, jnp.asarray(x), q, training=False,
                          method=type(jmodel).forward_single_quality)
    check_forward(model, ours, theirs, q)
    assert ours["x_hat"].min() >= 0 and ours["x_hat"].max() <= 1


def test_forward_single_quality_refuses_training(model_pair):
    """Training without a noise source is refused."""
    model, _, _ = model_pair
    with pytest.raises(ValueError, match="needs a noise source"):
        model.forward_single_quality(torch.from_numpy(image(22)), 5, training=True)


@pytest.mark.parametrize("model_pair", ["stacked"], indirect=True)
def test_entropy_estimate_eval_matches_jax(model_pair):
    model, jmodel, params = model_pair
    # JAX's evaluation on JAX's forward, run eagerly as above
    jcodec = types.SimpleNamespace(forward_single_quality=lambda x, q, mp: jmodel.apply(
        {"params": params}, x, q, mp, training=False, method=type(jmodel).forward_single_quality))
    images = [image(23)[0]]
    lm = [0.0055, 0.04]
    ours = entropy_estimate_eval(make_codec(model, lanes=64, device="cpu"), images,
                                 pr_list=(0.0, 10.0), lmbda_list=lm)
    theirs = jax_entropy_estimate_eval(jcodec, images, pr_list=(0.0, 10.0), lmbda_list=lm)
    assert ours["n_images"] == theirs["n_images"] == 1
    for a, b in zip(ours["bpp"], theirs["bpp"]):
        assert abs(a - b) <= 0.01 * b
    for a, b in zip(ours["psnr"], theirs["psnr"]):
        assert abs(a - b) <= 0.01
    assert abs(ours["loss"] - theirs["loss"]) <= 0.01 * abs(theirs["loss"])
