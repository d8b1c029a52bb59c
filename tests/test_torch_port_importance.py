"""PyTorch port vs the JAX package: the gradient importance map.

At TINY (N=32, M=64, dim_chunk 8, 32 scale levels), 64x64, on weights from
the port's `init_params` carried into the JAX tree by `import_progressive`.
JAX's `importance_map` runs once, jitted, in a module fixture (one JAX
gradient; on a CPU the jit compiles in about a third of the time of a
first eager call), with the snapped sigma of both of its forwards.  A replay
noise source feeds the port JAX's own draws: `normal(shape)` takes
`jax.random.normal` of the next of JAX's two keys (k1 for the base, k2 for
the enhancement) at the shape the port asks for, so a draw of another
shape or order changes the map and fails the test.

  * `snap_to_scale_table` equals JAX's exactly, on tests/test_importance.py's
    five values and on random sigma against TINY's table;
  * the map: the snapped sigma of both forwards agree with JAX's on at
    least 99.9% of the elements, and wherever they agree the map is within
    1e-4 of its largest value of JAX's.  The map is a product of a gradient
    and |y_b - y_e|, whose draws are scaled by the snapped sigma: where a
    sigma snaps to another table entry the map moves by a table step, so
    the bound holds only where the snaps agree;
  * no model parameter gets a gradient;
  * `ImportanceMapDataset` crops the same patch as JAX's (JAX's map is
    replaced by a stub there: its values differ by design, since the port
    draws from a torch.Generator), and its map is the port's
    `importance_map` on that patch with a generator seeded seed + i.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import progressivecodec_tpu.layers.importance as jax_importance
from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.data import datasets as jax_datasets
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.data.datasets import ImportanceMapDataset, SyntheticDataset
from progressivecodec_tpu_torch.layers.importance import importance_map, snap_to_scale_table
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.ops.conv import pad_image
from progressivecodec_tpu_torch.ops.noise import NoiseSource

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))
TABLE = CFG.scale_table.values()
Q_EPS = 1e-6


class ReplayNormal:
    """Replays JAX's two draws: the i-th `normal(shape)` call draws
    `jax.random.normal(keys[i], shape)`; the shapes asked for are kept."""

    def __init__(self, rng):
        self.keys = iter(jax.random.split(rng))
        self.shapes = []

    def normal(self, shape, device):
        self.shapes.append(tuple(shape))
        return torch.from_numpy(np.array(jax.random.normal(next(self.keys), tuple(shape)))).to(device)


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(21))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    x = np.random.default_rng(22).random((1, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(23)
    jmodel = JaxModel(cfg=JCFG)

    def run(variables, xx, key):
        snapped = []
        for q in (0.0, Q_EPS):
            out = jmodel.apply(variables, xx, q, "point-based-std", training=False,
                               method=JaxModel.forward_single_quality)
            snapped.append(jax_importance.snap_to_scale_table(out["std"], TABLE))
        return jax_importance.importance_map(jmodel, variables, xx, key, TABLE), snapped

    imap, snapped = jax.jit(run)({"params": params}, jnp.asarray(x), rng)
    return {"model": model, "x": x, "rng": rng, "imap": np.asarray(imap),
            "snapped": [np.asarray(s) for s in snapped]}


def test_snap_to_scale_table_matches_jax():
    table = np.array([0.1, 1.0, 10.0], np.float32)
    vals = np.array([-5.0, 0.05, 0.5, 2.0, 100.0], np.float32)
    got = snap_to_scale_table(torch.from_numpy(vals), table).numpy()
    np.testing.assert_array_equal(got, np.float32([0.1, 0.1, 1.0, 10.0, 10.0]))
    np.testing.assert_array_equal(got, np.asarray(jax_importance.snap_to_scale_table(vals, table)))
    rng = np.random.default_rng(24)
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(400.0), (2, 4, 4, 32))).astype(np.float32)
    sigma[0, 0, 0, :4] = TABLE[:4].astype(np.float32)  # exactly on a table entry
    sigma[0, 0, 1, :2] = (-1.0, 0.0)
    np.testing.assert_array_equal(snap_to_scale_table(torch.from_numpy(sigma), TABLE).numpy(),
                                  np.asarray(jax_importance.snap_to_scale_table(sigma, TABLE)))


def test_importance_map_matches_jax(setup):
    model = setup["model"]
    x = torch.from_numpy(setup["x"])
    with torch.no_grad():
        ours_snapped = [snap_to_scale_table(
            model.forward_single_quality(x, q, "point-based-std")["std"], TABLE).numpy()
            for q in (0.0, Q_EPS)]
    agree = np.ones(ours_snapped[0].shape, bool)
    for ours, theirs in zip(ours_snapped, setup["snapped"]):
        assert ours.shape == theirs.shape
        agree &= ours == theirs
    print(f"snapped sigma agree on {agree.mean():.4%} of {agree.size} elements")
    assert agree.mean() >= 0.999

    noise = ReplayNormal(setup["rng"])
    got = importance_map(model, x, noise, TABLE).numpy()
    want = setup["imap"]
    assert noise.shapes == [want.shape, want.shape]
    assert got.shape == want.shape == (1, 4, 4, CFG.division_channel)
    assert np.isfinite(got).all() and (got >= 0).all() and got.max() > 0
    err = np.abs(got - want)[agree].max() / np.abs(want).max()
    print(f"importance map: max |d| / max |m| = {err:.3g} where the snaps agree")
    assert err <= 1e-4
    assert all(p.grad is None for p in model.parameters())


def test_importance_map_dataset_crop_matches_jax(setup, monkeypatch):
    model = setup["model"]
    jds = jax_datasets.SyntheticDataset(n=2, size=80, seed=5)
    ds = SyntheticDataset(n=2, size=80, seed=5)
    h = w = 64 // 16
    monkeypatch.setattr(jax_importance, "importance_map",
                        lambda *a, **k: jnp.zeros((1, h, w, JCFG.division_channel)))
    jax_pairs = jax_datasets.ImportanceMapDataset(jds, None, None, TABLE, patch_size=64, seed=9)
    pairs = ImportanceMapDataset(ds, model, TABLE, patch_size=64, seed=9)
    assert len(pairs) == len(jax_pairs) == 2
    for i in range(2):
        np.testing.assert_array_equal(ds[i], jds[i])
        patch, imap = pairs[i]
        jpatch, jmap = jax_pairs[i]
        np.testing.assert_array_equal(patch, jpatch)
        assert imap.shape == jmap.shape and imap.dtype == np.float32
        x_pad, _ = pad_image(torch.from_numpy(np.ascontiguousarray(patch))[None], 64)
        want = importance_map(model, x_pad, NoiseSource.seeded(9 + i), TABLE)[0].numpy()
        np.testing.assert_array_equal(imap, want)
