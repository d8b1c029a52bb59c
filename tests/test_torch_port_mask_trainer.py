"""PyTorch port vs the JAX package: the MaskEstractor and its trainer.

At TINY (N=32, M=64, dim_chunk 8, 32 scale levels), 64x64, on codec weights
from the port's `init_params` carried into the JAX tree by
`import_progressive`, and on estractor weights from the port's
`init_mask_estractor` carried into JAX's tree (whose structure and shapes
are checked against `jax.eval_shape` of JAX's init).  Both sides train on
the same seeded target array, not on a second importance map.  JAX runs
one jit of `mask_features` with `predict_cust_map` and JAX's own
`make_mask_train_step` once (its only gradient); that step's gradients are
read back from optax's first moment, mu = (1 - b1) g.

  * the estractor's forward on the same features within 1e-5 of its
    largest output, and `mask_features` within 2e-4 (the forward's bound);
  * one train step: the loss within rtol 1e-4, every gradient leaf within
    1e-3 of its largest |g|, and each parameter after Adam's update, where
    both gradients have the same sign, within lr * (0.02 + |gp - gj| * eps
    / (min(|gp|, |gj|) + eps)^2) of optax's: 2% (torch corrects the bias in
    float64, optax in float32) plus the step's change between the two
    gradients near eps, where Adam's direction is steep;
  * five port steps reduce the loss;
  * `predict_cust_map` within 1e-4 of its largest value (it carries the
    forward's differences through the estractor);
  * the predicted map as `cust_map` through the port's codec at q=5:
    stream_ok, decoded y_hat equal to the encoder's, and keep flags unlike
    the sigma-ranked codec's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.layers.importance import MaskEstractor as JaxMaskEstractor
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive
from progressivecodec_tpu.training import mask_trainer as jax_mask_trainer

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_module, from_jax_params, init_params
from progressivecodec_tpu_torch.training.mask_trainer import (
    init_mask_estractor,
    make_mask_train_step,
    mask_features,
    predict_cust_map,
)

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))
LR = 1e-4


def jax_tree(module) -> dict:
    """The port module's conv weights as the Flax tree its JAX twin names."""
    tree = {}
    for name, child in module.named_children():
        if isinstance(child, torch.nn.Conv2d):
            tree[name] = {"kernel": child.weight.detach().permute(2, 3, 1, 0).numpy().copy(),
                          "bias": child.bias.detach().numpy().copy()}
        else:
            tree[name] = jax_tree(child)
    return tree


def as_torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(41))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    x = np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32)
    est = init_mask_estractor(torch.Generator().manual_seed(43), model)
    est_params = jax_tree(est)

    jmodel, jest = JaxModel(cfg=JCFG), JaxMaskEstractor(N=CFG.division_channel)
    run = jax.jit(lambda v, p, xx: (jax_mask_trainer.mask_features(jmodel, v, xx),
                                    jax_mask_trainer.predict_cust_map(jest, p, jmodel, v, xx)))
    feats, pred = run({"params": params}, est_params, jnp.asarray(x))
    feats = tuple(np.asarray(f) for f in feats)
    target = np.random.default_rng(44).exponential(2.0, np.asarray(pred).shape).astype(np.float32)

    tx, step = jax_mask_trainer.make_mask_train_step(jest, lr=LR)
    stepped, state, loss = step(est_params, tx.init(est_params), feats, jnp.asarray(target))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9), state[0].mu)
    return {"model": model, "x": x, "est": est, "jest": jest, "est_params": est_params,
            "feats": feats, "pred": np.asarray(pred), "target": target, "loss": float(loss),
            "stepped": jax.tree_util.tree_map(np.asarray, stepped), "grads": grads}


def test_mask_estractor_matches_jax(setup):
    est, feats = setup["est"], setup["feats"]
    shapes = jax.eval_shape(setup["jest"].init, jax.random.PRNGKey(0), *feats)["params"]
    assert (jax.tree_util.tree_map(lambda a: a.shape, setup["est_params"])
            == jax.tree_util.tree_map(lambda a: a.shape, shapes))
    assert "skip" in shapes["base_ent0"] and "skip" not in shapes["base_rep1"]
    sd = from_jax_module(setup["est_params"], est)
    assert set(sd) == set(est.state_dict())
    assert all(torch.equal(v, est.state_dict()[k]) for k, v in sd.items())
    want = np.asarray(setup["jest"].apply({"params": setup["est_params"]}, *feats))
    with torch.no_grad():
        got = est(*as_torch(feats)).numpy()
    assert got.shape == want.shape == (1, 4, 4, CFG.division_channel)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mask_features_match_jax(setup):
    got = mask_features(setup["model"], torch.from_numpy(setup["x"]))
    assert not any(f.requires_grad for f in got)
    for name, g, w in zip(("y_base", "y_p0", "params_base", "params_p0"), got, setup["feats"]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4, err_msg=name)


def _fresh_estractor(setup):
    est = init_mask_estractor(torch.Generator().manual_seed(0), setup["model"])
    est.load_state_dict(from_jax_module(setup["est_params"], est), strict=True)
    return est


def test_train_step_matches_jax(setup):
    est = _fresh_estractor(setup)
    before = {n: p.detach().clone() for n, p in est.named_parameters()}
    _, step = make_mask_train_step(est, lr=LR)
    loss = step(as_torch(setup["feats"]), torch.from_numpy(setup["target"]))
    np.testing.assert_allclose(float(loss), setup["loss"], rtol=1e-4)
    want_g = from_jax_module(setup["grads"], est)
    want_p = from_jax_module(setup["stepped"], est)
    worst, n_differ, n_total = 0.0, 0, 0
    for name, p in est.named_parameters():
        gp, gj = p.grad.double(), want_g[name].double()
        peak = float(gj.abs().max())
        err = float((gp - gj).abs().max())
        assert err <= 1e-3 * peak, (name, err, peak)
        worst = max(worst, err / peak)
        same = torch.sign(gp) == torch.sign(gj)
        n_differ += int((~same).sum())
        n_total += same.numel()
        assert float((p.detach() - before[name]).abs().max()) <= 1.01 * LR, name
        eps = 1e-8
        slack = (gp - gj).abs() * eps / (torch.minimum(gp.abs(), gj.abs()) + eps) ** 2
        diff = (p.detach().double() - want_p[name].double()).abs()
        assert not bool((same & (diff > LR * (0.02 + slack))).any()), name
    print(f"largest |dg| / max|g| {worst:.3g}; gradient signs differ at {n_differ} of {n_total}")
    assert n_differ <= 1e-3 * n_total


def test_training_reduces_loss(setup):
    est = _fresh_estractor(setup)
    _, step = make_mask_train_step(est, lr=1e-3)
    feats, target = as_torch(setup["feats"]), torch.from_numpy(setup["target"])
    losses = [float(step(feats, target)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_predict_cust_map_matches_jax(setup):
    est = _fresh_estractor(setup)
    got = predict_cust_map(est, setup["model"], torch.from_numpy(setup["x"])).numpy()
    want = setup["pred"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_predicted_map_through_the_codec(setup):
    model = setup["model"]
    x = torch.from_numpy(setup["x"])
    cust_map = predict_cust_map(_fresh_estractor(setup), model, x)
    codec = GranularCodec(model, lanes=64, device="cpu")
    kept = []
    orig = model.codec_prog_stacked

    def spy(*args):
        out = orig(*args)
        kept.append(out[3])
        return out

    model.codec_prog_stacked = spy
    try:
        data = codec.compress(x, quality=5, simulate=True, cust_map=cust_map)
        codec.compress(x, quality=5)
    finally:
        del model.codec_prog_stacked
    out = codec.decompress(codec.deserialize(codec.serialize(data)), cust_map=cust_map)
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"])
    by_map, by_sigma = kept
    assert int(by_map.sum()) == int(by_sigma.sum()) > 0
    assert not torch.equal(by_map, by_sigma)
