"""PyTorch port vs the JAX package: the postnets, GDN1, delta_mask, the
random mask policy and the OpenImages gate.

The JAX modules' parameter trees come from `jax.eval_shape` of their init
(no compile), filled with seeded numpy values (GDN's beta and gamma near
their init, so the normalisation stays away from zero); the port module
loads them through `models/weights.py:from_jax_module` with `strict=True`.
JAX is channel-last, the port's postnets NCHW.

  * each postnet (the three residual blocks, with and without a `skip`,
    GDN inverse, LatentPostNet, PostNet model_type 0 and 1 at N=16, M=24)
    within 1e-5 of its largest output of JAX's, on the same input;
  * GDN1, forward and inverse, within 1e-6 relative;
  * `delta_mask` exactly equal to JAX's;
  * the random policy keeps exactly int(n * pr * 10 / 100) elements per
    image, as many as JAX's keeps; a seeded generator repeats its mask and
    another seed moves it.  Its bits cannot match JAX's PRNG;
  * `download_openimages` raises an ImportError that names fiftyone when
    fiftyone is absent, as tests/test_cli.py checks JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.layers import blocks as jax_blocks
from progressivecodec_tpu.layers import masking as jax_masking
from progressivecodec_tpu.layers import postnets as jax_postnets

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.layers import postnets
from progressivecodec_tpu_torch.layers.blocks import GDN1
from progressivecodec_tpu_torch.layers.masking import channel_mask, delta_mask
from progressivecodec_tpu_torch.models.weights import from_jax_module

# name -> (JAX module, port module, input shapes, NHWC)
POSTNETS = {
    "residual_block": (lambda: jax_postnets.ResidualBlock(out=10),
                       lambda: postnets.ResidualBlock(6, 10), [(1, 8, 8, 6)]),
    "residual_block_small": (lambda: jax_postnets.ResidualBlockSmall(out=10),
                             lambda: postnets.ResidualBlockSmall(6, 10), [(1, 8, 8, 6)]),
    "residual_block_small_same_width": (lambda: jax_postnets.ResidualBlockSmall(out=6),
                                        lambda: postnets.ResidualBlockSmall(6, 6), [(1, 8, 8, 6)]),
    "residual_block_gdn": (lambda: jax_postnets.ResidualBlockGDN(out=10),
                           lambda: postnets.ResidualBlockGDN(6, 10), [(1, 8, 8, 6)]),
    "residual_block_gdn_inverse_same_width": (
        lambda: jax_postnets.ResidualBlockGDN(out=6, inverse=True),
        lambda: postnets.ResidualBlockGDN(6, 6, inverse=True), [(1, 8, 8, 6)]),
    "latent_postnet": (lambda: jax_postnets.LatentPostNet(N=8),
                       lambda: postnets.LatentPostNet(8), [(2, 4, 4, 8), (2, 4, 4, 16)]),
    "postnet_type0": (lambda: jax_postnets.PostNet(N=16, M=24, model_type=0),
                      lambda: postnets.PostNet(16, 24, model_type=0), [(1, 32, 32, 3)]),
    "postnet_type1": (lambda: jax_postnets.PostNet(N=16, M=24, model_type=1),
                      lambda: postnets.PostNet(16, 24, model_type=1), [(1, 64, 64, 3)]),
}


def seeded_tree(shapes, seed):
    """Seeded values for a parameter tree of `jax.ShapeDtypeStruct`s."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "beta":
            return (1.0 + 0.2 * rng.random(s.shape)).astype(np.float32)
        if name == "gamma":
            return (0.1 * np.eye(s.shape[0]) + 0.02 * rng.random(s.shape)).astype(np.float32)
        if name == "rel_pos_bias":
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias" or name.endswith("_bias"):
            return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", list(POSTNETS))
def test_postnet_matches_jax(name):
    make_jax, make_port, in_shapes = POSTNETS[name]
    jmod, mod = make_jax(), make_port()
    rng = np.random.default_rng(61)
    xs = [rng.random(s).astype(np.float32) for s in in_shapes]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *xs)["params"]
    params = seeded_tree(shapes, 62)
    mod.load_state_dict(from_jax_module(params, mod), strict=True)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, *xs))
    with torch.no_grad():
        got = mod(*[nchw(x) for x in xs]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_matches_jax(inverse):
    rng = np.random.default_rng(63)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    jmod = jax_blocks.GDN1(inverse=inverse)
    params = seeded_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], 64)
    mod = GDN1(6, inverse=inverse)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    want = np.asarray(jmod.apply({"params": params}, x))
    with torch.no_grad():
        got = mod(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pr_bar,pr", [(0.0, 5.0), (2.5, 7.5), (3.0, 10.0), (4.0, 4.0)])
def test_delta_mask_matches_jax(pr_bar, pr):
    scale = np.exp(np.random.default_rng(65).standard_normal((2, 4, 4, 8))).astype(np.float32)
    got = delta_mask(torch.from_numpy(scale), pr_bar, pr).numpy()
    want = np.asarray(jax_masking.delta_mask(jnp.asarray(scale), pr_bar, pr))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize("pr", [0.0, 0.3, 2.5, 10.0])
def test_random_mask_policy(pr):
    scale = torch.ones((2, 4, 4, 8))
    n = scale.numel() // 2
    num_ones = int(n * (pr * 10) / 100.0)

    def mask(seed):
        return channel_mask(scale, pr=pr, mask_pol="random",
                            generator=torch.Generator().manual_seed(seed))

    m = mask(7)
    assert m.shape == scale.shape and m.dtype == torch.float32
    assert m.reshape(2, -1).sum(1).tolist() == [num_ones, num_ones]
    jm = np.asarray(jax_masking.channel_mask(jnp.ones((2, 4, 4, 8)), pr=pr, mask_pol="random",
                                             rng=jax.random.PRNGKey(7)))
    assert jm.reshape(2, -1).sum(1).tolist() == [num_ones, num_ones]
    assert torch.equal(m, mask(7))
    if 0 < num_ones < n:
        assert not torch.equal(m, mask(8))
    with pytest.raises(ValueError, match="Generator"):
        channel_mask(scale, pr=pr, mask_pol="random")


def test_openimages_downloader_gated():
    from progressivecodec_tpu_torch.data.openimages import download_openimages

    try:
        import fiftyone  # noqa: F401
        pytest.skip("fiftyone installed; skipping the offline-gate check")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="fiftyone"):
        download_openimages("/nonexistent-openimages-root")
