"""PyTorch port vs the JAX package: WACNN, the single-rate codec ("cnn").

On weights from the port's `init_params` carried into the JAX tree by
`import_wacnn`:
  * `from_jax_params` equals JAX `export_wacnn` and loads strictly;
  * the port round trip is bit-exact with stream_ok, with one stream and
    with two sub-streams; a quality above 0 codes the same single rate;
  * `codec_hyper_dec` and every base-slice fragment agree with JAX's within
    2e-4 on the same inputs, with idx exact, and the stream is within 1% of
    JAX's in bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.torch_import import export_wacnn, import_wacnn
from progressivecodec_tpu.models.wacnn import WACNN as JaxWACNN
from test_torch_port_variants import _close_or_equal, _j, image, share_jax_compiles
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec, make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.wacnn import WACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

KW = dict(name="cnn", N=32, M=64, dim_chunk=8)
CFG = ModelConfig(**KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**KW, scale_table=JaxScaleTableConfig(levels=32))


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(4))
    params = import_wacnn({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = get_model(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model, params


def test_wacnn_weights_map_like_export_wacnn(setup):
    model, params = setup
    assert isinstance(model, WACNN)
    ours, ref = from_jax_params(params, CFG), export_wacnn(params, JCFG)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("q", [0, 5])
def test_wacnn_roundtrip_bit_exact(setup, groups, q):
    model, _ = setup
    codec = make_codec(model, lanes=64, groups=groups, device="cpu")
    x = torch.from_numpy(image(20))
    data = codec.compress(x, quality=q, simulate=True)
    out = codec.decompress(codec.deserialize(codec.serialize(data)))
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"]) and torch.equal(out["x_hat"], data["x_hat"])
    assert out["y_hat"].shape == (1, 4, 4, CFG.M)
    base = codec.compress(x, quality=0, simulate=True)
    assert torch.equal(base["y_hat"], data["y_hat"]) and base["num_bytes"] == data["num_bytes"]


def test_wacnn_fragments_and_bytes_match_jax(setup, monkeypatch):
    model, params = setup
    share_jax_compiles()
    jcodec = JaxGranularCodec(JaxWACNN(cfg=JCFG), {"params": params}, lanes=64)
    x = image(21)
    j_data = jcodec.compress(jnp.asarray(x), quality=0)
    calls = []
    for name in ("codec_hyper_dec", "codec_base_params", "codec_base_step"):
        orig = getattr(model, name)

        def spy(*args, _orig=orig, _name=name):
            out = _orig(*args)
            calls.append((_name, args, out))
            return out

        monkeypatch.setattr(model, name, spy)
    p_data = GranularCodec(model, lanes=64, device="cpu").compress(torch.from_numpy(x), quality=0)
    monkeypatch.undo()
    assert abs(p_data["num_bytes"] - j_data["num_bytes"]) <= 0.01 * j_data["num_bytes"]
    # codec_base_step calls codec_base_params itself: its outputs are the step's
    calls = [c for c in calls if c[0] != "codec_base_params" or c[1][0] == 0]
    assert [c[0] for c in calls].count("codec_base_step") == CFG.M // CFG.dim_chunk - 1
    for name, args, out in calls:
        if name == "codec_hyper_dec":
            theirs, exact = jcodec._call(name, (), _j(args[0])), (False, False)
        elif name == "codec_base_params":
            theirs, exact = jcodec._call(name, (args[0],), *_j(args[1:])), (False, False, True, False)
        else:  # (y_prev, mu, scale, idx, mean_support)
            theirs = jcodec._call(name, args[:2], *_j(args[2:]))
            exact = (False, False, False, True, False)
        for k, (a, b, e) in enumerate(zip(out, theirs, exact)):
            _close_or_equal(f"{name} output {k}", a, b, e)
