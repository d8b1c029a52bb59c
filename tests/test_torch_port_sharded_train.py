"""PyTorch port: the train step over a (data, model) mesh of two ranks.

One 2-rank gloo job on the CPU (tests/torch_port_ranks.py) runs every case
of this file.
  * `shard_params_rule` shards a port parameter exactly where JAX's rule
    shards its leaf, and along the torch dim that holds the leaf's last
    axis, leaf by leaf through `from_jax_params`, on the TINY and the
    flagship parameter shapes (`jax.eval_shape` of JAX's init: no forward
    and no compile);
  * on meshes (2, 1) and (1, 2), one sharded step at TINY (batch 4,
    64x64) against the port's single-process `make_train_step` on the
    same global batch, weights and noise: loss within rtol 1e-5, every
    gradient within 1e-4 of its leaf's largest |g|, every parameter within
    1e-6; on (1, 2) also after a second step, whose Adam reads the sharded
    moments.  The single-process step is held to JAX's
    by tests/test_torch_port_train_step.py, and JAX's sharded step is
    sharding annotations on that same function, so no JAX step is compiled
    here;
  * on (1, 2) each rank holds half of every sharded leaf and its Adam
    moments, and all of the replicated ones; a state stepped once in one
    process and then sharded takes its second step as one process would;
  * `RankSliceNoise` gives each rank its slice of the global draw, for the
    bottleneck's (C, 1, B*H*W), the channel-last (B, ...) and the stacked
    (S, B, ...) layouts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_port_ranks
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
TINY = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
# steps per mesh: one, as the contract asks, and a second on "model", whose
# Adam then reads its sharded moments.  On "data" the halves' gradients are
# summed in another order, and a second Adam step, whose random-weight
# gradients are clipped to near its eps, would magnify that past 1e-6
MESHES = {(2, 1): 1, (1, 2): 2}


def _batch():
    return np.random.default_rng(70).random((4, 64, 64, 3)).astype(np.float32)


def _state(cfg):
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.models.weights import init_params
    from progressivecodec_tpu_torch.training.step import init_train_state

    model = get_model(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)), strict=True)
    return init_train_state(model, TrainConfig())


# ---------------------------------------------------------------------------
# the ranks' job
# ---------------------------------------------------------------------------


def _placements(cfg, mesh):
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.parallel.mesh import shard_params_rule

    rule = shard_params_rule(mesh)
    out = {}
    for mod_name, mod in get_model(cfg, device="meta").named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            place = rule(mod, pname, p)
            out[f"{mod_name}.{pname}" if mod_name else pname] = getattr(place, "dim", None)
    return out


def _noise_slices(rank):
    from progressivecodec_tpu_torch.ops.noise import NoiseSource, RankSliceNoise

    ok = []
    for shape, axis in (((8, 1, 2 * 3 * 5), 2), ((2, 3, 5, 8), 0), ((4, 2, 3, 5, 8), 1)):
        got = RankSliceNoise(NoiseSource.seeded(3), rank, 2)
        full = NoiseSource.seeded(3)
        g_shape = list(shape)
        g_shape[axis] *= 2
        for _ in range(2):  # a second draw continues the global sequence
            want = full.uniform(g_shape, "cpu").narrow(axis, rank * shape[axis], shape[axis])
            ok.append(torch.equal(got.uniform(shape, "cpu"), want))
    return ok


def rank_job(rank, world, workdir):
    from progressivecodec_tpu_torch.ops.noise import NoiseSource
    from progressivecodec_tpu_torch.parallel.mesh import make_mesh
    from progressivecodec_tpu_torch.parallel.sharding import (
        gather_full,
        make_sharded_train_step,
        resident_param_bytes,
        shard_train_state,
    )
    from progressivecodec_tpu_torch.training.step import make_train_step

    out = {"noise": _noise_slices(rank), "steps": {}}
    x = torch.from_numpy(_batch())

    ref = _state(TINY)
    ref_losses, ref_params, ref_grads = [], [], []
    step = make_train_step()
    noise = NoiseSource.seeded(11)
    for _ in range(max(MESHES.values())):
        ref, metrics = step(ref, x, noise)
        ref_losses.append({k: float(v) for k, v in metrics.items()})
        ref_params.append({n: p.detach().clone() for n, p in ref.model.named_parameters()})
        ref_grads.append({n: p.grad.clone() for n, p in ref.model.named_parameters()
                          if p.grad is not None})

    for shape, n_steps in MESHES.items():
        mesh = make_mesh(*shape, device_type="cpu")
        if shape == (1, 2):
            out["placements"] = {"tiny": _placements(TINY, mesh),
                                 "flagship": _placements(ModelConfig(), mesh)}
        state = shard_train_state(_state(TINY), mesh)
        step = make_sharded_train_step(mesh)
        noise = NoiseSource.seeded(11)
        losses = []
        for _ in range(n_steps):
            state, metrics = step(state, x, noise)
            losses.append({k: float(v) for k, v in metrics.items()})
        params, grads = gather_full(state), gather_full(state, grads=True)
        want_params, want_grads = ref_params[n_steps - 1], ref_grads[n_steps - 1]
        sharded = [s.storage for s in state.shards]
        names = {s.name for s in state.shards}
        moments = [tuple(state.opt.main.state[s.storage]["exp_avg"].shape) == tuple(s.storage.shape)
                   for s in state.shards if s.storage in state.opt.main.state]
        out["steps"][shape] = dict(
            losses=losses, ref_losses=ref_losses[:n_steps],
            grad_err={n: (float((grads[n] - g).abs().max()), float(g.abs().max()))
                      for n, g in want_grads.items()},
            missing_grads=sorted(set(grads) ^ set(want_grads)),
            param_err=max(float((params[n] - p).abs().max()) for n, p in want_params.items()),
            resident=resident_param_bytes(state),
            sharded_bytes=sum(4 * s.numel() for s in sharded),
            full_sharded_bytes=sum(4 * p.numel() for n, p in want_params.items() if n in names),
            replicated_bytes=sum(4 * p.numel() for n, p in want_params.items() if n not in names),
            n_shards=len(sharded), moments_sharded=moments,
        )

    # a state that has stepped once in one process, then sharded: its Adam
    # moments are sliced with the parameters
    mesh = make_mesh(1, 2, device_type="cpu")
    noise = NoiseSource.seeded(11)
    state, _ = make_train_step()(_state(TINY), x, noise)
    state, metrics = make_sharded_train_step(mesh)(shard_train_state(state, mesh), x, noise)
    params = gather_full(state)
    out["resumed"] = dict(
        loss=float(metrics["loss"]), ref_loss=ref_losses[1]["loss"],
        param_err=max(float((params[n] - p).abs().max()) for n, p in ref_params[1].items()),
    )
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_port_ranks.run_ranks("test_torch_port_sharded_train",
                                      tmp_path_factory.mktemp("sharded_train"), timeout=300)


def _jax_marked_tree(jcfg):
    """JAX's parameter tree of `jcfg` (shapes from `jax.eval_shape`), each
    leaf filled with 1000 * (JAX's rule shards it on a 2-wide "model" axis)
    + the index along its last axis."""
    import jax

    from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
    from progressivecodec_tpu.parallel.mesh import make_mesh, shard_params_rule

    rule = shard_params_rule(make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]))
    shapes = jax.eval_shape(lambda r: JaxModel(cfg=jcfg).init(
        {"params": r}, jax.numpy.zeros((1, 64, 64, 3)), training=False), jax.random.PRNGKey(0))

    def mark(leaf):
        sharded = leaf.ndim >= 1 and tuple(rule(leaf).spec) == (None,) * (leaf.ndim - 1) + ("model",)
        last = np.arange(leaf.shape[-1], dtype=np.float32) if leaf.ndim else np.float32(0)
        return np.broadcast_to(1000.0 * sharded + last, leaf.shape).astype(np.float32)

    return jax.tree.map(mark, shapes["params"])


@pytest.mark.timeout(600)
@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_shard_params_rule_matches_jax(ranks, which):
    from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
    from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig

    from progressivecodec_tpu_torch.models.weights import from_jax_params

    cfg, jcfg = (TINY, JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))) \
        if which == "tiny" else (ModelConfig(), JaxModelConfig())
    marked = from_jax_params(_jax_marked_tree(jcfg), cfg)
    placements = ranks[0]["placements"][which]
    assert placements == ranks[1]["placements"][which]
    assert set(placements) == set(marked)
    n_sharded = 0
    for name, t in marked.items():
        jax_shards = bool((t >= 1000).all())
        assert jax_shards or bool((t < 1000).all()), name
        dim = placements[name]
        assert (dim is not None) == jax_shards, name
        n_sharded += jax_shards
        if dim is not None:  # the shard dim holds the JAX leaf's last axis
            idx = torch.arange(t.shape[dim], dtype=torch.float32)
            view = [1] * t.dim()
            view[dim] = -1
            assert torch.equal(t - 1000, idx.view(view).expand_as(t)), name
    assert n_sharded > 0


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", list(MESHES), ids=["data2", "model2"])
def test_sharded_step_matches_single_process(ranks, shape):
    for r in ranks:
        got = r["steps"][shape]
        for ours, ref in zip(got["losses"], got["ref_losses"]):
            for k in ("loss", "aux_loss", "loss_total", "bpp_loss", "mse_last"):
                assert ours[k] == pytest.approx(ref[k], rel=1e-5), k
        assert not got["missing_grads"], got["missing_grads"]
        for name, (err, peak) in got["grad_err"].items():
            assert err <= 1e-4 * peak, f"{name}: {err} vs peak {peak}"
        assert got["param_err"] <= 1e-6


@pytest.mark.timeout(600)
def test_model_axis_holds_half_of_each_sharded_leaf(ranks):
    got = [r["steps"][(1, 2)] for r in ranks]
    for g in got:
        assert g["n_shards"] > 0 and all(g["moments_sharded"]) and g["moments_sharded"]
        assert g["resident"] == g["sharded_bytes"] + g["replicated_bytes"]
        assert 2 * g["sharded_bytes"] == g["full_sharded_bytes"]
        assert g["sharded_bytes"] == got[0]["sharded_bytes"]
    for r in ranks:
        assert r["steps"][(2, 1)]["n_shards"] == 0


@pytest.mark.timeout(600)
def test_rank_slice_noise_is_the_global_draw(ranks):
    for r in ranks:
        assert r["noise"] and all(r["noise"]), r["noise"]


@pytest.mark.timeout(600)
def test_sharding_a_stepped_state_keeps_its_moments(ranks):
    for r in ranks:
        got = r["resumed"]
        assert got["loss"] == pytest.approx(got["ref_loss"], rel=1e-5)
        assert got["param_err"] <= 1e-6
