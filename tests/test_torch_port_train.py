"""PyTorch port vs the JAX package: the training modules, without a JAX
gradient.

  * every loss entry point of training/loss.py on seeded numpy inputs,
    every returned value within rtol 1e-6 of JAX's;
  * the optimiser split: the aux group is exactly the bottleneck's
    quantiles, as JAX's `_param_labels` marks them, leaf for leaf through
    `from_jax_params`;
  * the dual Adam alone on a seeded small tree over 3 steps against optax
    (`make_optimizer_scheduled`), with the global-norm clip active, and the
    plateau scale 0.3 set before the third step: parameters within rtol
    1e-6 plus 2e-5 of the lr of optax's (optax corrects Adam's bias in
    float32: its first update is 1 - 6.6e-6 of the lr where torch's is 1);
  * `plateau_update` sequences, equal to JAX's;
  * the three freeze filters against JAX's `freeze_mask`, by mapped module
    name, over five configurations, and `masked_optimizer`;
  * `warmstart_from_anchor` against JAX's, exact, with and without the
    second hyperprior and the enhancement anchor;
  * `random_crop`, `PatchLoader(workers=1)`, `NaturalSyntheticDataset`
    (cached and uncached) and `ImageFolderDataset`'s cap and host striping,
    exact against JAX;
  * `utils/rd.bd_rate` against JAX's;
  * JAX's `save_params_npz` -> the port's `load_params_npz` ->
    `from_jax_params` gives back the weights;
  * `Codec.update`: cached until `force=True`, which rebuilds the tables
    a fresh codec builds after the bottleneck's weights change;
  * `TrainConfig` and its JSON equal JAX's, and a device mesh is refused.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from progressivecodec_tpu import config as jax_config
from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.data import datasets as jax_datasets
from progressivecodec_tpu.models import warmstart as jax_warmstart
from progressivecodec_tpu.models.torch_import import import_progressive, import_rem, import_wacnn
from progressivecodec_tpu.training import freeze as jax_freeze
from progressivecodec_tpu.training import loss as jax_loss
from progressivecodec_tpu.training import optim as jax_optim
from progressivecodec_tpu.training.checkpoint import save_params_npz as jax_save_params_npz
from progressivecodec_tpu.utils import rd as jax_rd
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch import config as port_config
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.data import datasets
from progressivecodec_tpu_torch.models import warmstart
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.training import freeze, loss, optim
from progressivecodec_tpu_torch.training.checkpoint import load_params_npz
from progressivecodec_tpu_torch.utils import rd

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
F32 = np.float32


def tiny(**kw):
    """(port config, JAX config) of the TINY model with `kw`."""
    kw = {"name": "channel", **TINY_KW, **kw}
    return (ModelConfig(**kw, scale_table=ScaleTableConfig(levels=32)),
            JaxModelConfig(**kw, scale_table=JaxScaleTableConfig(levels=32)))


def jax_tree(cfg, jcfg, seed=0):
    """(port state dict, the same weights as a JAX params tree)."""
    sd = init_params(cfg, torch.Generator().manual_seed(seed))
    importer = {"channel": import_progressive, "rate": import_rem, "cnn": import_wacnn}[cfg.name]
    return sd, importer({k: v.numpy() for k, v in sd.items()}, jcfg)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed=0):
    """Seeded loss inputs.  The images lie on a 1/16 grid, so each squared
    error and every partial sum of them is exact in float32 and an MSE does
    not depend on the order of the reduction; the likelihood tensors hold
    at most 128 values.  (At 2x32x48 on arbitrary floats JAX's float32 mean
    is itself 2e-6 off the float64 value, the port's 6e-9.)"""
    rng = np.random.default_rng(seed)
    b, h, w = 1, 16, 32
    grid = lambda *s: (rng.integers(0, 17, s) / 16).astype(F32)  # noqa: E731
    lik = lambda *s: rng.uniform(1e-4, 1.0, s).astype(F32)  # noqa: E731
    return {
        "target": grid(b, h, w, 3),
        "x_hat": grid(2, b, h, w, 3),
        "x_hat1": grid(b, h, w, 3),
        "y": lik(b, h // 16, w // 16, 32),
        "y_prog": lik(1, b, h // 16, w // 16, 64),
        "z": lik(b, 1, 1, 32),
        "y_hat": rng.standard_normal((b, h // 16, w // 16, 64)).astype(F32),
        "y_base": rng.standard_normal((b, h // 16, w // 16, 32)).astype(F32),
        "t_enh": rng.standard_normal((b, h // 16, w // 16, 64)).astype(F32),
        "t_base": rng.standard_normal((b, h // 16, w // 16, 32)).astype(F32),
    }


def _outputs(a, conv):
    """The loss entry points' inputs in one framework (conv: numpy -> its array)."""
    c = {k: conv(v) for k, v in a.items()}
    stacked = {"x_hat": c["x_hat"], "likelihoods": {"y": c["y"], "y_prog": c["y_prog"],
                                                    "z": c["z"]},
               "y_hat": c["y_hat"], "y_base": c["y_base"]}
    single = {"x_hat": c["x_hat1"], "likelihoods": {"y": c["y"], "z": c["z"]}}
    # teachers: a fixed latent shifted by the target's mean
    t_enh = lambda t: c["t_enh"] + t.mean()  # noqa: E731
    t_base = lambda t: c["t_base"] + 0.5 * t.mean()  # noqa: E731
    return c["target"], stacked, single, t_enh, t_base


LMBDA = (0.0055, 0.04)
LOSS_CASES = {
    "scalable_rate_distortion": lambda m, t, s, w, te, tb: m.scalable_rate_distortion_loss(s, t, LMBDA),
    "rate_distortion": lambda m, t, s, w, te, tb: m.rate_distortion_loss(w, t, 0.013),
    "distortion_stacked": lambda m, t, s, w, te, tb: m.distortion_loss(s, t),
    "distortion_single": lambda m, t, s, w, te, tb: m.distortion_loss(w, t),
    "latent": lambda m, t, s, w, te, tb: m.latent_loss(s["y_hat"], te(t)),
    "mask_rate_distortion_stacked": lambda m, t, s, w, te, tb: m.mask_rate_distortion_loss(s, t, 0.04),
    "mask_rate_distortion_single": lambda m, t, s, w, te, tb: m.mask_rate_distortion_loss(w, t, 0.04),
    "scalable_distilled_rd": lambda m, t, s, w, te, tb: m.scalable_distilled_rate_distortion_loss(
        s, t, LMBDA, te),
    "scalable_distilled_rd_base": lambda m, t, s, w, te, tb: m.scalable_distilled_rate_distortion_loss(
        s, t, LMBDA, te, tb, gamma=0.3),
    "distilled_rate": lambda m, t, s, w, te, tb: m.distilled_rate_loss(s, t, LMBDA, te),
    "scalable_distilled_distortion": lambda m, t, s, w, te, tb: m.scalable_distilled_distortion_loss(
        s, t, LMBDA, te),
    "scalable_distilled_distortion_base": lambda m, t, s, w, te, tb:
        m.scalable_distilled_distortion_loss(s, t, LMBDA, te, tb, gamma=0.7),
    "rate": lambda m, t, s, w, te, tb: m.rate_loss(s, t.shape, 2),
    "rate_single": lambda m, t, s, w, te, tb: m.rate_loss(w, t.shape, 1),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_matches_jax(case):
    a = _loss_inputs()
    ours = LOSS_CASES[case](loss, *_outputs(a, torch.from_numpy))
    theirs = LOSS_CASES[case](jax_loss, *_outputs(a, jnp.asarray))
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), np.asarray(theirs[k], np.float64),
                                   rtol=1e-6, atol=0, err_msg=f"{case}: {k}")


# ---------------------------------------------------------------------------
# optimiser split, dual Adam, plateau
# ---------------------------------------------------------------------------


def test_param_labels_match_jax():
    cfg, jcfg = tiny()
    sd, params = jax_tree(cfg, jcfg)
    labels = jax_optim._param_labels(params)
    as_arrays = jax.tree.map(lambda lab, p: np.full(np.shape(p), lab == "aux", F32), labels, params)
    mapped = from_jax_params(as_arrays, cfg)
    model = get_model(cfg, device="cpu")
    ours = optim.param_labels(model)
    assert set(ours) == set(mapped)
    for name, label in ours.items():
        want = mapped[name]
        assert bool(want.all()) == (label == "aux") and bool(want.any()) == (label == "aux"), name
    assert [n for n, lab in ours.items() if lab == "aux"] == ["entropy_bottleneck.quantiles"]
    opt = optim.Optimizers(model)
    assert opt.aux_params == [model.entropy_bottleneck.quantiles]
    assert len(opt.main_params) == len(ours) - 1
    assert all(p is not model.entropy_bottleneck.quantiles for p in opt.main_params)


class _Tree(torch.nn.Module):
    """A small seeded tree: two main leaves and the aux quantiles."""

    def __init__(self, values: dict):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(values["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(values["b"].copy()))
        self.entropy_bottleneck = torch.nn.Module()
        self.entropy_bottleneck.quantiles = torch.nn.Parameter(
            torch.from_numpy(values["entropy_bottleneck"]["quantiles"].copy()))


def test_dual_adam_matches_optax():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(F32), "b": rng.standard_normal(5).astype(F32),
              "entropy_bottleneck": {"quantiles": rng.standard_normal((3, 1, 3)).astype(F32)}}
    lr, aux_lr = 1e-2, 1e-1
    tx = jax_optim.make_optimizer_scheduled(lr, aux_lr, 1.0)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    model = _Tree(params)
    opt = optim.Optimizers(model, lr, aux_lr, 1.0)
    norms = []
    for step, gain in enumerate((3.0, 0.2, 5.0)):  # clipped, not clipped, clipped
        grads = jax.tree.map(lambda p: (gain * rng.standard_normal(p.shape)).astype(F32), params)
        main_norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                      for g in (grads["w"], grads["b"]))))
        norms.append(main_norm)
        if step == 2:
            j_state = jax_optim.set_lr_scale(j_state, 0.3)
            optim.set_lr_scale(opt, 0.3)
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for (name, p) in model.named_parameters():
            node = grads
            for part in name.split("."):
                node = node[part]
            p.grad = torch.from_numpy(node.copy())
        opt.step()
        for name, p in model.named_parameters():
            node = j_params
            for part in name.split("."):
                node = node[part]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(node), rtol=1e-6,
                                       atol=2e-5 * (aux_lr if "quantiles" in name else lr),
                                       err_msg=f"{name} after step {step + 1}")
    assert norms[0] > 1.0 and norms[1] < 1.0 and norms[2] > 1.0, norms


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(4)
    grads = [(3 * rng.standard_normal(s)).astype(F32) for s in ((7, 5), (11,), (2, 3, 4))]
    params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.float32)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = optim.clip_by_global_norm_(params, 1.0)
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    assert float(norm) > 1.0
    for p, want in zip(params, clipped):
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want))


def test_clip_below_max_norm_keeps_the_gradients_bits():
    rng = np.random.default_rng(5)
    grads = [(0.1 * rng.standard_normal(s)).astype(F32) for s in ((7, 5), (11,))]
    params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.float32)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = optim.clip_by_global_norm_(params, 1.0)
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    assert float(norm) < 1.0
    for p, g, want in zip(params, grads, clipped):
        np.testing.assert_array_equal(p.grad.numpy(), g)
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("metrics", [
    [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0 + 1e-9, 3.5, 3.5, 3.5, 3.5, 3.5, 3.5, 3.5],
    [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 0.5, 0.5, float("nan"), 0.4],
])
def test_plateau_matches_jax(metrics):
    ours, theirs = optim.plateau_init(), jax_optim.plateau_init()
    assert tuple(ours) == tuple(theirs)
    for m in metrics:
        ours = optim.plateau_update(ours, m, factor=0.3, patience=2)
        theirs = jax_optim.plateau_update(theirs, m, factor=0.3, patience=2)
        assert tuple(ours) == tuple(theirs), m
    assert ours.scale < 1.0


# ---------------------------------------------------------------------------
# freeze, warm start
# ---------------------------------------------------------------------------

FREEZE_CONFIGS = {
    "stacked": dict(),
    "hyper_unet_joiner": dict(multiple_hyperprior=True, u_net_post=2, joiner_policy="cond",
                              stack_prog=False),
    "learnable_single": dict(mask_policy="three-levels-learnable", multiple_encoder=False,
                             multiple_decoder=False, u_net_post=1),
    "rem": dict(name="rate"),
    "wacnn": dict(name="cnn"),
}
FILTERS = {
    "base_net": lambda f: f.freeze_base_net_fn(),
    "base_net_hyper_dec": lambda f: f.freeze_base_net_fn(multiple_hyperprior=True, freeze_dec=True),
    "rem": lambda f: f.rem_freeze_fn(),
    "decoder_only": lambda f: f.decoder_only_fn(),
}


@pytest.mark.parametrize("config", list(FREEZE_CONFIGS))
def test_freeze_filters_match_jax(config):
    cfg, jcfg = tiny(**FREEZE_CONFIGS[config])
    _, params = jax_tree(cfg, jcfg)
    model = get_model(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    mapped = {n: freeze.jax_module_name(n, cfg) for n in names}
    assert set(mapped.values()) == set(params), "every JAX module maps from a port parameter"
    for fname, make in FILTERS.items():
        mask = jax_freeze.freeze_mask(params, make(jax_freeze))
        opt = freeze.masked_optimizer(model, make(freeze))
        for name, p in model.named_parameters():
            leaves = jax.tree.leaves(mask[mapped[name]])
            assert all(v == p.requires_grad for v in leaves), (fname, name)
        trainable = {id(p) for p in model.parameters() if p.requires_grad}
        assert {id(p) for p in opt.main_params + opt.aux_params} == trainable, fname


@pytest.mark.parametrize("hyper,enh", [(False, False), (True, True)])
def test_warmstart_matches_jax(hyper, enh):
    cfg, jcfg = tiny(multiple_hyperprior=hyper)
    acfg, ajcfg = tiny(name="cnn", M=32)
    prog_sd, prog = jax_tree(cfg, jcfg, seed=1)
    anchor_sd, anchor = jax_tree(acfg, ajcfg, seed=2)
    enh_sd, enh_p = jax_tree(acfg, ajcfg, seed=3) if enh else (None, None)
    theirs = jax_warmstart.warmstart_from_anchor(prog, anchor, enh_p, multiple_hyperprior=hyper)
    jax_warmstart.check_warmstart_shapes(prog, theirs)
    ours = warmstart.warmstart_from_anchor(prog_sd, anchor_sd, enh_sd, multiple_hyperprior=hyper)
    warmstart.check_warmstart_shapes(prog_sd, ours)
    want = from_jax_params(jax.tree.map(np.asarray, theirs), cfg)
    assert set(ours) == set(want)
    for k in want:
        assert torch.equal(ours[k], want[k]), k
    assert torch.equal(ours["g_a.0.0.weight"], anchor_sd["g_a.0.weight"])
    assert torch.equal(ours["g_a.1.0.weight"], prog_sd["g_a.1.0.weight"])
    get_model(cfg, device="cpu").load_state_dict(ours, strict=True)
    bad = dict(ours)
    bad["g_s.0.1.weight"] = bad["g_s.0.1.weight"][:, :1]
    with pytest.raises(ValueError, match="shape mismatch"):
        warmstart.check_warmstart_shapes(prog_sd, bad)


# ---------------------------------------------------------------------------
# data, rd, npz, codec tables, config
# ---------------------------------------------------------------------------


def test_random_crop_matches_jax():
    img = np.random.default_rng(0).random((40, 30, 3)).astype(F32)
    for size in (16, 30, 48):  # inside, at the edge, reflect-padded
        ours = datasets.random_crop(img, size, np.random.default_rng(size))
        theirs = jax_datasets.random_crop(img, size, np.random.default_rng(size))
        np.testing.assert_array_equal(ours, theirs)
        assert ours.shape == (size, size, 3)


def test_patch_loader_matches_jax():
    ds = datasets.SyntheticDataset(n=10, size=48)
    ours = datasets.PatchLoader(ds, 3, 32, seed=5, workers=1)
    theirs = jax_datasets.PatchLoader(jax_datasets.SyntheticDataset(n=10, size=48), 3, 32, seed=5,
                                      workers=1)
    for epoch in (0, 1):
        a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # a consumer that stops after one batch releases the workers
    two = datasets.PatchLoader(ds, 1, 32, seed=5, prefetch=1, workers=2)
    for i, _ in enumerate(two.epoch(0)):
        break
    assert i == 0


def test_natural_synthetic_dataset_matches_jax():
    for cache in (True, False):
        ours = datasets.NaturalSyntheticDataset(n=3, size=40, seed=2, cache=cache)
        theirs = jax_datasets.NaturalSyntheticDataset(n=3, size=40, seed=2, cache=cache)
        assert len(ours) == len(theirs) == 3
        for i in (1, 1, 0):  # the second read of 1 comes from the uint8 cache
            np.testing.assert_array_equal(ours[i], theirs[i])
    first, again = ours[2], datasets.NaturalSyntheticDataset(n=3, size=40, seed=2)
    again[2]
    assert np.abs(again[2] - first).max() <= 0.5 / 255 + 1e-7 and not np.array_equal(again[2], first)


def test_image_folder_striping_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    root = tmp_path / "train" / "data"
    root.mkdir(parents=True)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(root / f"im{i}.png")
    for num, host, hosts in ((None, 0, 1), (5, 1, 2), (6, 2, 3), (None, 0, 2)):
        ours = datasets.ImageFolderDataset(str(tmp_path), "train", num, host, hosts)
        theirs = jax_datasets.ImageFolderDataset(str(tmp_path), "train", num, host, hosts)
        assert ours.files == theirs.files and len(ours) > 0
        np.testing.assert_array_equal(ours[0], theirs[0])


def test_bd_rate_matches_jax():
    r1, d1 = rd.BASE_ANCHOR_BPP, rd.BASE_ANCHOR_PSNR
    r2 = [0.9 * r for r in r1]
    d2 = [d + 0.1 for d in d1]
    assert rd.bd_rate(r1, d1, r2, d2) == jax_rd.bd_rate(r1, d1, r2, d2) < 0
    assert rd.PROGRESSIVE_ANCHOR_BPP == jax_rd.PROGRESSIVE_ANCHOR_BPP
    assert rd.rd_curve_dict(r2, d2, "x") == jax_rd.rd_curve_dict(r2, d2, "x")
    with pytest.raises(ValueError, match="overlap"):
        rd.bd_rate(r1, d1, r1, [d + 50 for d in d1])


def test_jax_npz_loads_into_the_port(tmp_path):
    cfg, jcfg = tiny(name="rate")
    sd, params = jax_tree(cfg, jcfg, seed=4)
    jax_save_params_npz(str(tmp_path / "p.npz"), params)
    back = from_jax_params(load_params_npz(str(tmp_path / "p.npz")), cfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(back, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_codec_update_force_rebuilds_the_tables():
    cfg, _ = tiny()
    model = get_model(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(8)), strict=True)
    codec = make_codec(model, lanes=64, device="cpu")
    before = codec.update()
    dev_before = codec.device_tables
    with torch.no_grad():  # an optimiser step moves the quantiles and the MLP
        eb = model.entropy_bottleneck
        eb.quantiles.add_(torch.tensor([-3.0, 0.4, 2.5], dtype=torch.float32).reshape(1, 1, 3))
        eb._bias0.add_(0.3)
    assert codec.update() is before and codec.device_tables is dev_before
    forced = codec.update(force=True)
    fresh = make_codec(model, lanes=64, device="cpu").update()
    assert forced is not before and codec.device_tables is not dev_before
    for field in ("cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(forced, field), getattr(fresh, field))
    assert not np.array_equal(forced.cdf_length, before.cdf_length)


def test_train_config_matches_jax():
    assert json.loads(port_config.to_json(TrainConfig())) == json.loads(
        jax_config.to_json(jax_config.TrainConfig()))
    text = jax_config.to_json(dataclasses.replace(jax_config.TrainConfig(), lr=3e-4, epochs=7))
    assert port_config.train_config_from_json(text) == TrainConfig(lr=3e-4, epochs=7)
    # the mesh axes are held as JAX holds them (and read nowhere, as in JAX)
    meshed = dataclasses.replace(jax_config.TrainConfig(), mesh_data=4, mesh_tile=2)
    assert port_config.train_config_from_json(jax_config.to_json(meshed)) == TrainConfig(
        mesh_data=4, mesh_tile=2)
