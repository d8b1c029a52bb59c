"""PyTorch port vs the JAX package: one training step, on the same weights,
batch and noise.

At TINY (N=32, M=64, dim_chunk 8, 32 scale levels), 64x64, batch 2, on
weights from the port's `init_params` carried into the JAX tree by
`import_progressive`.  A replay noise source feeds the port JAX's own
draws: each `uniform(shape)` takes the next of JAX's keys, in the order
JAX's forward uses them, and draws `jax.random.uniform` of the shape the
port asks for, so a draw of another shape or out of order fails the test.

  * the stacked layout at q=(0, 10), against JAX's `_apply_with_aux` and
    `scalable_rate_distortion_loss` under `jax.value_and_grad` (jitted, once,
    with optax's step, in a module-scoped fixture: on a CPU that compile
    takes about half as long as one eager `jax.value_and_grad` of it):
    likelihoods within rtol 1e-3, every loss term and the aux loss within
    rtol 1e-4, and every gradient leaf, mapped to the port's names by
    `from_jax_params`, within 1e-3 of the leaf's largest |g|.  x_hat is
    held within 2e-4 or 2e-5 of its largest magnitude: with random weights
    the unclipped enhancement synthesis reaches ~700, and against a float64
    evaluation of the same forward JAX's float32 x_hat is 1.0e-5 of that
    peak off and the port's 0.7e-5, so the two part by up to ~1.1e-5; the
    port is also held within 1e-5 of the peak of that float64 evaluation;
  * the parameters after one step of the port's dual Adam against optax's
    update through `make_optimizer_scheduled` with `set_lr_scale(0.3)`:
    Adam's first step moves each element by lr*scale * u(g), u(g) =
    g / (|g| + eps), g clipped by the global norm, eps 1e-8.  With random
    weights the norm is large and most clipped gradients are near eps, where
    u is steep, so each element is held, where both gradients have the same
    sign, within lr*scale * (0.02 + |gp - gj| * eps / (min(|gp|, |gj|) +
    eps)^2): 2% plus the step's change over the two clipped gradients gp
    and gj, whose distance the gradient test bounds.  The elements where the
    signs differ are counted;
  * forward and loss only: the unrolled CLI default (one decoder),
    REM with live banks at q=(0, 1.0) (the straight-through attention
    mask), `forward_single_quality(training=True)` (one JAX key for every
    draw) and WACNN with `rate_distortion_loss`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.rem import PostRateProcessedNetwork as JaxREM
from progressivecodec_tpu.models.torch_import import import_progressive, import_rem, import_wacnn
from progressivecodec_tpu.models.wacnn import WACNN as JaxWACNN
from progressivecodec_tpu.training import loss as jax_loss
from progressivecodec_tpu.training import optim as jax_optim
from progressivecodec_tpu.training.step import _apply_with_aux
from test_torch_port_rem import live_rem_weights
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.training import loss, optim
from progressivecodec_tpu_torch.training.step import train_loss

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
LR, AUX_LR, SCALE = 1e-4, 1e-3, 0.3
LOSS_KEYS = ("loss", "bpp_loss", "bpp_base", "bpp_scalable", "bpp_hyper")


class Replay:
    """A noise source that replays JAX's draws: the i-th `uniform` call
    draws `jax.random.uniform(keys[i], shape, float32, -0.5, 0.5)`."""

    def __init__(self, keys):
        self.keys = iter(keys)

    def uniform(self, shape, device):
        u = jax.random.uniform(next(self.keys), tuple(shape), jnp.float32, -0.5, 0.5)
        return torch.from_numpy(np.array(u)).to(device)


def tiny(**kw):
    kw = {"name": "channel", **TINY_KW, **kw}
    return (ModelConfig(**kw, scale_table=ScaleTableConfig(levels=32)),
            JaxModelConfig(**kw, scale_table=JaxScaleTableConfig(levels=32)))


def build(cfg, jcfg, sd):
    """(port model on the CPU, JAX params) on the weights `sd`."""
    importer = {"channel": import_progressive, "rate": import_rem, "cnn": import_wacnn}[cfg.name]
    params = importer({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return model, params


def batch(seed=0):
    return np.random.default_rng(seed).random((2, 64, 64, 3)).astype(np.float32)


def forward_keys(cfg, rng, qualities):
    """JAX's multi-quality forward splits 1 + ns1 + len(qualities) * ns0
    keys up front and takes them in order."""
    return list(jax.random.split(rng, 1 + cfg.ns1 + len(qualities) * cfg.ns0))


def check_forward(ours, theirs, x_rel=2e-5):
    """x_hat within 2e-4 or `x_rel` of its largest magnitude (random weights
    drive the unclipped synthesis far past 1), likelihoods within rtol 1e-3."""
    x = np.asarray(theirs["x_hat"])
    atol = max(2e-4, x_rel * float(np.abs(x).max()))
    np.testing.assert_allclose(ours["x_hat"].detach().numpy(), x, rtol=0, atol=atol)
    assert set(ours["likelihoods"]) == set(theirs["likelihoods"])
    for k, v in theirs["likelihoods"].items():
        np.testing.assert_allclose(ours["likelihoods"][k].detach().numpy(), np.asarray(v),
                                   rtol=1e-3, atol=0, err_msg=f"likelihood {k}")


def check_losses(ours, theirs, keys=LOSS_KEYS):
    for k in keys:
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def stacked():
    """The stacked TINY model's loss, aux loss, gradients and one optax step
    in JAX (one jit: value_and_grad, then `make_optimizer_scheduled` at
    plateau scale 0.3) and the loss, aux loss and gradients in the port
    (one backward)."""
    cfg, jcfg = tiny()
    model, params = build(cfg, jcfg, init_params(cfg, torch.Generator().manual_seed(31)))
    x = batch(1)
    rng = jax.random.PRNGKey(7)
    jmodel = JaxModel(cfg=jcfg)

    def loss_fn(p, xb, key):
        out, aux = _apply_with_aux(jmodel, p, xb, [0, 10], None, key)
        losses = jax_loss.scalable_rate_distortion_loss(out, xb, jcfg.lmbda_list)
        return losses["loss"] + aux, (out, losses, aux)

    tx = jax_optim.make_optimizer_scheduled(LR, AUX_LR, 1.0)

    def grad_and_step(p, xb, key):
        value, grads = jax.value_and_grad(loss_fn, has_aux=True)(p, xb, key)
        updates, _ = tx.update(grads, jax_optim.set_lr_scale(tx.init(p), SCALE), p)
        return value, grads, optax.apply_updates(p, updates)

    (total, (j_out, j_losses, j_aux)), j_grads, j_stepped = jax.jit(grad_and_step)(
        params, jnp.asarray(x), rng)

    noise = Replay(forward_keys(cfg, rng, [0, 10]))
    out = model(torch.from_numpy(x), [0, 10], training=True, noise=noise)
    aux = model.entropy_bottleneck.aux_loss()
    losses = loss.scalable_rate_distortion_loss(out, torch.from_numpy(x), cfg.lmbda_list)
    (losses["loss"] + aux).backward()
    return dict(cfg=cfg, model=model, params=params, out=out, losses=losses, aux=aux,
                j_out=j_out, j_losses=j_losses, j_aux=j_aux, j_total=total,
                j_grads=jax.tree.map(np.asarray, j_grads),
                j_stepped=jax.tree.map(np.asarray, j_stepped))


class Replay64(Replay):
    def uniform(self, shape, device):
        return super().uniform(shape, device).double()


def test_stacked_forward_and_loss_match_jax(stacked):
    s = stacked
    check_forward(s["out"], s["j_out"])
    # the port within 1e-5 of the peak of its own forward in float64
    model64 = get_model(s["cfg"], device="cpu").double()
    model64.load_state_dict(s["model"].state_dict())
    with torch.no_grad():
        exact = model64(torch.from_numpy(batch(1)).double(), [0, 10], training=True,
                        noise=Replay64(forward_keys(s["cfg"], jax.random.PRNGKey(7), [0, 10])))
    x64 = exact["x_hat"].numpy()
    np.testing.assert_allclose(s["out"]["x_hat"].detach().numpy(), x64, rtol=0,
                               atol=1e-5 * float(np.abs(x64).max()))
    for k in ("y_base", "y_prog"):
        np.testing.assert_allclose(s["out"][k].detach().numpy(), np.asarray(s["j_out"][k]),
                                   rtol=0, atol=2e-4, err_msg=k)
    check_losses(s["losses"], s["j_losses"])
    np.testing.assert_allclose(float(s["aux"]), float(s["j_aux"]), rtol=1e-4)
    np.testing.assert_allclose(float(s["losses"]["loss"] + s["aux"]), float(s["j_total"]),
                               rtol=1e-4)


def test_stacked_gradients_match_jax(stacked):
    """Every gradient leaf within 1e-3 of its largest |g|; the worst ratio
    reached is printed (5.4e-4 on these weights)."""
    s = stacked
    want = from_jax_params(s["j_grads"], s["cfg"])
    worst = 0.0
    for name, p in s["model"].named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.numpy(), want[name].numpy()
        peak = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-3 * peak or err == 0.0, (name, err, peak)
        if peak > 0:
            worst = max(worst, err / peak)
    print(f"largest |dg| / max|g| over the leaves: {worst:.3g}")
    assert float(np.abs(want["entropy_bottleneck.quantiles"].numpy()).max()) > 0


def test_one_step_matches_optax(stacked):
    """Each parameter after one step of the port's dual Adam, at plateau
    scale 0.3, against optax's update of the same gradients."""
    s = stacked
    want = from_jax_params(s["j_stepped"], s["cfg"])
    j_grads = from_jax_params(s["j_grads"], s["cfg"])
    model = s["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = optim.Optimizers(model, LR, AUX_LR, 1.0)
    optim.set_lr_scale(opt, SCALE)
    opt.step()
    main = [w for n, w in j_grads.items() if n != "entropy_bottleneck.quantiles"]
    norm = float(np.sqrt(sum(np.sum(w.double().numpy() ** 2) for w in main)))
    n_differ = n_total = 0
    for name, p in model.named_parameters():
        aux = name == "entropy_bottleneck.quantiles"
        step = AUX_LR if aux else LR * SCALE
        gp = p.grad.double()  # clipped by now
        gj = j_grads[name].double() * (1.0 if aux else min(1.0, 1.0 / norm))
        same = torch.sign(gp) == torch.sign(gj)
        n_differ += int((~same).sum())
        n_total += same.numel()
        moved = (p.detach() - before[name]).abs()
        assert float(moved.max()) <= 1.01 * step, name
        eps = 1e-8
        slack = (gp - gj).abs() * eps / (torch.minimum(gp.abs(), gj.abs()) + eps) ** 2
        err = (p.detach().double() - want[name].double()).abs()
        bad = same & (err > step * (0.02 + slack))
        assert not bool(bad.any()), (name, int(bad.sum()))
    print(f"gradient signs differ at {n_differ} of {n_total} elements")
    assert n_differ <= 1e-3 * n_total


def test_unrolled_cli_default_forward_and_loss_match_jax():
    cfg, jcfg = tiny(multiple_decoder=False, stack_prog=False)
    model, params = build(cfg, jcfg, init_params(cfg, torch.Generator().manual_seed(32)))
    x = batch(2)
    rng = jax.random.PRNGKey(8)
    j_out = JaxModel(cfg=jcfg).apply({"params": params}, jnp.asarray(x), [0, 10], training=True,
                                     rng=rng)
    with torch.no_grad():
        out = model(torch.from_numpy(x), [0, 10], training=True,
                    noise=Replay(forward_keys(cfg, rng, [0, 10])))
    check_forward(out, j_out)
    check_losses(loss.scalable_rate_distortion_loss(out, torch.from_numpy(x), cfg.lmbda_list),
                 jax_loss.scalable_rate_distortion_loss(j_out, jnp.asarray(x), jcfg.lmbda_list))


def test_rem_live_banks_forward_and_loss_match_jax():
    """REM at q=(0, 1.0): the bank of the interval (0.25, 1.75] runs, gated
    by the straight-through attention mask."""
    cfg, jcfg = tiny(name="rate")
    model, params = build(cfg, jcfg, live_rem_weights(cfg, seed=33))
    x = batch(3)
    rng = jax.random.PRNGKey(9)
    jmodel = JaxREM(cfg=jcfg)

    def run(m):
        return m(jnp.asarray(x), [0, 1.0], training=True, rng=rng), m.aux_loss()

    j_out, j_aux = jmodel.apply({"params": params}, method=run)
    with torch.no_grad():
        total, metrics = train_loss(model, torch.from_numpy(x), (0, 1.0),
                                    noise=Replay(forward_keys(cfg, rng, [0, 1.0])))
        out = model(torch.from_numpy(x), [0, 1.0], training=True,
                    noise=Replay(forward_keys(cfg, rng, [0, 1.0])))
    check_forward(out, j_out)
    j_losses = jax_loss.scalable_rate_distortion_loss(j_out, jnp.asarray(x), jcfg.lmbda_list)
    check_losses(metrics, j_losses)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(j_aux), rtol=1e-4)
    np.testing.assert_allclose(float(total), float(j_losses["loss"] + j_aux), rtol=1e-4)


def test_forward_single_quality_training_matches_jax():
    """JAX passes its one key to every draw, so the replay repeats it."""
    cfg, jcfg = tiny()
    model, params = build(cfg, jcfg, init_params(cfg, torch.Generator().manual_seed(34)))
    x = batch(4)
    key = jax.random.PRNGKey(10)
    jmodel = JaxModel(cfg=jcfg)
    theirs = jmodel.apply({"params": params}, jnp.asarray(x), 5, training=True, rng=key,
                          method=JaxModel.forward_single_quality)
    with torch.no_grad():
        ours = model.forward_single_quality(torch.from_numpy(x), 5, training=True,
                                            noise=Replay([key] * (1 + cfg.ns0 + 1)))
    check_forward(ours, theirs)
    for k in ("y_hat", "mu", "std"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=0, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(ours["mask"].numpy(), np.asarray(theirs["mask"]))


def test_wacnn_forward_and_loss_match_jax():
    """WACNN splits 2 + num_slices keys and draws z from key 0 and slice i
    from key 2 + i."""
    cfg, jcfg = tiny(name="cnn")
    model, params = build(cfg, jcfg, init_params(cfg, torch.Generator().manual_seed(35)))
    x = batch(5)
    rng = jax.random.PRNGKey(11)
    theirs = JaxWACNN(cfg=jcfg).apply({"params": params}, jnp.asarray(x), training=True, rng=rng)
    keys = list(jax.random.split(rng, 2 + model.num_slices))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), training=True, noise=Replay([keys[0]] + keys[2:]))
    check_forward(ours, theirs)
    check_losses(loss.rate_distortion_loss(ours, torch.from_numpy(x), 0.013),
                 jax_loss.rate_distortion_loss(theirs, jnp.asarray(x), 0.013),
                 keys=("loss", "bpp_loss", "mse"))
