"""PyTorch port vs the JAX package: the ChannelProgressiveWACNN variants.

The matrix of tests/test_variants.py (u_net_post, joiners, the second
hyperprior, all_scalable + support_std, the learnable mask, the residual
order, total_mu_rep), plus delta_encode + support_progressive_slices=2 +
total_mu_rep, and the reference CLI default (one decoder, unrolled
enhancement).  For each, on weights from the port's `init_params` carried
into the JAX tree by `import_progressive`:
  * the port round trip is bit-exact with stream_ok, with one stream and
    with two sub-streams (PCT1-G);
  * the enhancement fragment (`codec_prog_params` per unrolled slice, or
    `codec_prog_stacked`) and `codec_hyper_dec` agree with JAX's within
    2e-4 on the same inputs, with mask, keep and idx exact; with u_net_post,
    synthesis + refinement agree within 1e-5 of their largest magnitude;
  * the stream is within 1% of JAX's in bytes.
JAX compiles every fragment of every variant (~10 s each on this CPU), so
JAX is compared on a subset that still covers every branch: not for
u_net_post_1 (u_net_post_2 runs the same UNet) and not for
joiner_channel_res (joiner_cond runs the same joiner code).  To keep each
file near a minute, the variants are spread over four files that share
the helpers here: this one (u_net_post), test_torch_port_variants_joiner.py
(joiners, second hyperprior, residual order),
test_torch_port_variants_unrolled.py (all_scalable, learnable mask,
total_mu_rep) and test_torch_port_variants_delta.py (delta_encode, the CLI
default).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import export_progressive, import_progressive
from test_variants import VARIANTS as JAX_VARIANTS

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
VARIANTS = {
    **JAX_VARIANTS,
    "delta_sps2_total_mu_rep": dict(delta_encode=True, support_progressive_slices=2,
                                    total_mu_rep=True),
    "single_decoder_unrolled": dict(multiple_decoder=False, stack_prog=False),
}
NO_JAX = {"u_net_post_1", "joiner_channel_res"}
HERE = ["u_net_post_1", "u_net_post_2"]


def qualities(kw) -> list:
    """test_variants' grid: the learnable levels, or two sigma qualities."""
    return [1, 2] if "learnable" in kw.get("mask_policy", "") else [2.0, 10.0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six test processes on the CPU at once: torch's own
    thread pool per process would oversubscribe the cores many times over
    and slow every port round trip by an order of magnitude, so the port's
    test modules run torch on one thread (the previous count comes back
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def share_jax_compiles():
    """Let this process's JAX compiles be found again by their HLO: the
    variants' codecs compile the same analysis, hyperprior, base-slice and
    coder fragments, which then compile once.  Idempotent."""
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", tempfile.mkdtemp(prefix="jax-compiles-"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def build_variant(name):
    """(port model, JAX codec or None, JAX params) on the same seeded weights."""
    share_jax_compiles()
    kw = VARIANTS[name]
    cfg = ModelConfig(**TINY_KW, **kw, scale_table=ScaleTableConfig(levels=32))
    jcfg = JaxModelConfig(**TINY_KW, **kw, scale_table=JaxScaleTableConfig(levels=32))
    sd = init_params(cfg, torch.Generator().manual_seed(11))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = ChannelProgressiveWACNN(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    jcodec = None if name in NO_JAX else JaxGranularCodec(JaxModel(cfg=jcfg), {"params": params}, lanes=64)
    return model, jcodec, params


def image(seed):
    return np.random.default_rng(seed).random((1, 64, 64, 3)).astype(np.float32)


def roundtrip(model, x, q, groups):
    codec = GranularCodec(model, lanes=64, groups=groups, device="cpu")
    data = codec.compress(torch.from_numpy(x), quality=q, simulate=True)
    out = codec.decompress(codec.deserialize(codec.serialize(data)))
    assert out["stream_ok"], (q, groups)
    assert torch.equal(out["y_hat"], data["y_hat"]), (q, groups)
    assert torch.equal(out["x_hat"], data["x_hat"]), (q, groups)


def _j(a):
    if a is None:
        return None
    if isinstance(a, (tuple, list)):
        return tuple(_j(v) for v in a)
    return jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a


def _close_or_equal(name, ours, theirs, exact):
    theirs = np.asarray(theirs)
    ours = ours.numpy()
    assert ours.shape == theirs.shape, (name, ours.shape, theirs.shape)
    if exact:
        np.testing.assert_array_equal(ours, theirs.astype(ours.dtype), err_msg=name)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-4, err_msg=name)


def check_fragments_and_bytes(model, jcodec, q, monkeypatch):
    """Port compress with its fragments recorded; each recorded call is
    replayed through JAX's compiled fragment; then the bytes."""
    x = image(7)
    j_data = jcodec.compress(jnp.asarray(x), quality=q)
    calls = []
    names = ["codec_hyper_dec", "codec_prog_stacked" if model.stacked else "codec_prog_params"]
    for name in names:
        orig = getattr(model, name)

        def spy(*args, _orig=orig, _name=name):
            out = _orig(*args)
            calls.append((_name, args, out))
            return out

        monkeypatch.setattr(model, name, spy)
    codec = GranularCodec(model, lanes=64, device="cpu")
    p_data = codec.compress(torch.from_numpy(x), quality=q, simulate=model.cfg.u_net_post > 0)
    monkeypatch.undo()
    assert abs(p_data["num_bytes"] - j_data["num_bytes"]) <= 0.01 * j_data["num_bytes"]
    assert {c[0] for c in calls} == set(names)
    for name, args, out in calls:
        if name == "codec_hyper_dec":
            theirs = jcodec._call(name, (), _j(args[0]))
            exact = (False, False)
        elif name == "codec_prog_stacked":
            quality, mask_pol, *rest = args
            theirs = jcodec._call(name, (float(quality), mask_pol), *_j(rest))
            exact = (False, False, True, True, True, False, False)  # mask, keep, idx
        else:
            i, quality, mask_pol, *rest = args
            theirs = jcodec._call(name, (i, float(quality), mask_pol), *_j(rest))
            exact = (False, False, False, True, True, True, False)
        for k, (a, b, e) in enumerate(zip(out, theirs, exact)):
            _close_or_equal(f"{name} output {k}", a, b, e)
    if model.cfg.u_net_post:
        # synthesis + refinement before the clamp: with random weights the
        # UNet reaches magnitudes ~1e3, so the bound is float32 noise
        # relative to the largest output
        y = p_data["y_hat"]
        with torch.no_grad():
            ours = nhwc(model._apply_refine(model._synth_net(1)(nchw(y)), 1)).numpy()
        synth = jax.jit(lambda variables, v: jcodec.model.apply(
            variables, v, method=lambda m, v: m._apply_refine(m._synth_net(1)(v), 1)))
        theirs = np.asarray(synth(jcodec.variables, jnp.asarray(y.numpy())))
        assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()


@pytest.fixture(scope="module", params=HERE)
def variant(request):
    return (request.param, *build_variant(request.param))


def check_weights(name, model, params):
    """from_jax_params equals JAX export_progressive key for key and value
    for value, and names exactly the port model's parameters."""
    jcfg = JaxModelConfig(**TINY_KW, **VARIANTS[name], scale_table=JaxScaleTableConfig(levels=32))
    ours, ref = from_jax_params(params, model.cfg), export_progressive(params, jcfg)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


# The three tests below are repeated in each variant file over its own HERE.


@pytest.mark.parametrize("groups", [1, 2])
def test_variant_roundtrip_bit_exact(variant, groups):
    name, model, _, _ = variant
    for q in qualities(VARIANTS[name]):
        roundtrip(model, image(3), q, groups)


@pytest.mark.parametrize("variant", [n for n in HERE if n not in NO_JAX], indirect=True)
def test_variant_fragments_and_bytes_match_jax(variant, monkeypatch):
    name, model, jcodec, _ = variant
    check_fragments_and_bytes(model, jcodec, qualities(VARIANTS[name])[0], monkeypatch)


def test_variant_weights_map_like_export_progressive(variant):
    check_weights(variant[0], variant[1], variant[3])
