"""PyTorch port: the codec in the PCT1-G grouped wire format.

  * compress -> serialize -> deserialize -> decompress is bit-exact with
    stream_ok at groups in {2, 4}, at q in {0, 5};
  * the grouped y_hat equals the one-stream codec's on the same image, and
    the stream bytes are within 1% of the JAX grouped codec's on the same
    weights;
  * the auto lane policy picks JAX's lane count;
  * a container coded with another group count is refused in both
    directions, and so is a corrupt lane count;
  * one container dict at every group count, one stream included: G
    `streams` and `escs`, the same dict through the bytes, and the words
    of the stage-level encoder.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.coder import rans_device
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))


def _image(seed, batch=1):
    return torch.from_numpy(np.random.default_rng(seed).random((batch, 64, 64, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(0))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model, params


def _roundtrip(codec, x, q):
    data = codec.compress(x, quality=q, simulate=True)
    back = codec.deserialize(codec.serialize(data))
    out = codec.decompress(back)
    assert out["stream_ok"], f"q={q}"
    assert torch.equal(out["y_hat"], data["y_hat"]), f"q={q}"
    assert torch.equal(out["x_hat"], data["x_hat"]), f"q={q}"
    return data, back, out


@pytest.mark.parametrize("q", [0, 5])
@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_roundtrip_bit_exact(setup, groups, q):
    model, _ = setup
    codec = GranularCodec(model, lanes=64, groups=groups, device="cpu")
    data, back, _ = _roundtrip(codec, _image(50 + q), q)
    assert data["groups"] == back["groups"] == groups and len(back["streams"]) == groups
    assert data["num_bytes"] == 2 * sum(len(w) + len(e) for w, e in zip(back["streams"], back["escs"]))
    one = GranularCodec(model, lanes=64, device="cpu").compress(_image(50 + q), quality=q, simulate=True)
    assert torch.equal(one["y_hat"], data["y_hat"])


def test_grouped_escapes_roundtrip(setup):
    model, _ = setup
    codec = GranularCodec(model, lanes=64, groups=4, device="cpu")
    y = torch.from_numpy(80.0 * np.random.default_rng(3).normal(0, 1, (1, 4, 4, CFG.M)).astype(np.float32))
    data = codec.compress_from_latent(y, (1, 64, 64, 3), quality=10, simulate=True)
    assert sum(len(e) for e in data["escs"]) > 0
    out = codec.decompress(codec.deserialize(codec.serialize(data)))
    assert out["stream_ok"] and torch.equal(out["y_hat"], data["y_hat"])


def test_grouped_bytes_match_jax(setup):
    model, params = setup
    jcodec = JaxGranularCodec(JaxModel(cfg=JCFG), {"params": params}, lanes=64, groups=4)
    x = _image(60)
    j_data = jcodec.compress(jnp.asarray(x.numpy()), quality=5)
    assert bool(jcodec.decompress(j_data)["stream_ok"])
    p_data = GranularCodec(model, lanes=64, groups=4, device="cpu").compress(x, quality=5)
    assert len(p_data["streams"]) == len(j_data["streams"]) == 4
    assert abs(p_data["num_bytes"] - j_data["num_bytes"]) <= 0.01 * j_data["num_bytes"]


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_grouped_auto_lane_policy_matches_jax(setup, groups):
    model, params = setup
    ours = GranularCodec(model, lanes=512, groups=groups, lane_policy="auto", device="cpu")
    theirs = JaxGranularCodec(JaxModel(cfg=JCFG), {"params": params}, lanes=512, groups=groups,
                              lane_policy="auto")
    for batch, z_shape, q in [(1, (4, 4), 0), (1, (4, 4), 10), (2, (32, 48), 5), (8, (32, 48), 10),
                              (1, (128, 128), 10)]:
        assert ours._lanes_for_stream(batch, z_shape, q) == theirs._lanes_for_stream(batch, z_shape, q)
    data, _, _ = _roundtrip(ours, _image(61), 5)
    assert data["lanes"] == 64


@pytest.mark.parametrize("enc,dec", [(1, 4), (4, 1), (2, 4)])
def test_group_count_mismatch_refused(setup, enc, dec):
    model, _ = setup
    data = GranularCodec(model, lanes=64, groups=enc, device="cpu").compress(_image(62), quality=0)
    with pytest.raises(ValueError, match="groups"):
        GranularCodec(model, lanes=64, groups=dec, device="cpu").decompress(data)


def test_corrupt_grouped_lane_count_refused(setup):
    model, _ = setup
    codec = GranularCodec(model, lanes=64, groups=4, device="cpu")
    data = codec.compress(_image(63), quality=0)
    with pytest.raises(ValueError, match="lanes"):
        codec.deserialize(codec.serialize({**data, "lanes": 66}))
    with pytest.raises(ValueError, match="lanes"):
        GranularCodec(model, lanes=66, groups=4, device="cpu")


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_one_container_dict_at_every_group_count(setup, groups, monkeypatch):
    """`compress` gives the same keys at every G, one stream being G = 1:
    G `streams` and G `escs`; serialize -> deserialize gives that dict back;
    and the container's words are those of `rans_device.encode_stages` at G
    groups on the stages compress coded, per group (n_words, n_esc, words,
    escape words) after the header."""
    model, _ = setup
    codec = GranularCodec(model, lanes=64, groups=groups, device="cpu")
    seen = []
    encode = rans_device.encode_stages
    monkeypatch.setattr(rans_device, "encode_stages", lambda stages, *a: seen.append(stages) or encode(stages, *a))
    data = codec.compress(_image(64), quality=5)
    head = {"z_shape", "batch", "quality", "mask_pol", "lanes", "groups"}
    assert set(data) == head | {"streams", "escs", "num_bytes"}
    assert data["groups"] == len(data["streams"]) == len(data["escs"]) == groups
    blob = codec.serialize(data)
    back = codec.deserialize(blob)
    assert set(back) == head | {"streams", "escs"} and all(back[k] == data[k] for k in head)
    for got, want in zip(back["streams"] + back["escs"], data["streams"] + data["escs"]):
        np.testing.assert_array_equal(got, want.numpy().view(np.uint16))

    (stages,) = seen
    streams, n_words, escs, n_escs = encode(stages, codec.device_tables, 64, groups)
    body = b"".join(
        struct.pack("<II", int(n_words[g]), 2 * int(n_escs[g]))
        + streams[g, : int(n_words[g])].numpy().view(np.uint16).astype("<u2").tobytes()
        + escs[g, : 2 * int(n_escs[g])].numpy().view(np.uint16).astype("<u2").tobytes()
        for g in range(groups))
    assert blob[19 + len(data["mask_pol"]) :] == body
