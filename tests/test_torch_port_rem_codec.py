"""PyTorch port: REM through the codec, and the escalation cascade (its
parity with JAX's is in test_torch_port_rem_escalation.py).

At TINY with live banks (tests/test_torch_port_rem.py, `live_rem_weights`):
  * `get_model(ModelConfig(name="rate"))` -> `make_codec` -> compress ->
    serialize -> deserialize -> decompress is bit-exact with stream_ok at
    q in {0.01, 0.25, 1.0, 10}, with one stream and with two sub-streams;
    REM always takes the unrolled enhancement path;
  * its stream is within 1% of the JAX codec's in bytes on the same weights,
    at q in {0.25, 1.0, 10} with one stream and with two sub-streams, and
    past the 5-byte header (magic and format version) byte-identical;
  * the banks are live: at q=1.0 the kept elements and the bytes differ from
    the identity model's (zero_out = 0), and a checkpoint representation
    changes the bytes;
  * the escalation cascade at q=10 codes three checkpoint containers and
    the final one; each decodes with stream_ok after a trip through the
    container bytes, the decoder's anchors equal the encoder's bit for bit,
    and so do the final y_hat and x_hat; at q <= 0.01 it codes no
    checkpoint;
  * a quality that float32 cannot hold (0.58) is coded at the container's
    float32 value, so the decoder ranks the mask as the encoder did.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.models.codec_granular import GranularCodec as JaxGranularCodec
from progressivecodec_tpu.models.rem import PostRateProcessedNetwork as JaxREM
from test_torch_port_rem import CFG, JCFG, build_rem, live_rem_weights
from test_torch_port_variants import image, share_jax_compiles
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.models import rem
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model


@pytest.fixture(scope="module")
def setup():
    return build_rem()


def through_container(codec, data):
    return codec.deserialize(codec.serialize(data))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("q", [0.01, 0.25, 1.0, 10.0])
def test_rem_roundtrip_bit_exact(setup, q, groups):
    model, _ = setup
    assert isinstance(model, rem.PostRateProcessedNetwork) and not model.stacked
    codec = make_codec(model, lanes=64, groups=groups, device="cpu")
    data = codec.compress(torch.from_numpy(image(30)), quality=q, simulate=True)
    out = codec.decompress(through_container(codec, data))
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"]) and torch.equal(out["x_hat"], data["x_hat"])
    assert out["y_hat"].shape == (1, 4, 4, CFG.num_prog_slices * CFG.dim_chunk)


@pytest.fixture(scope="module")
def jax_codecs(setup):
    """groups -> the JAX codec on the same weights (compiles shared)."""
    _, params = setup
    share_jax_compiles()
    return {g: JaxGranularCodec(JaxREM(cfg=JCFG), {"params": params}, lanes=64, groups=g)
            for g in (1, 2)}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("q", [0.25, 1.0, 10.0])
def test_rem_bytes_match_jax(setup, jax_codecs, q, groups):
    model, _ = setup
    x = image(31)
    theirs = jax_codecs[groups].compress(jnp.asarray(x), quality=q)
    codec = make_codec(model, lanes=64, groups=groups, device="cpu")
    ours = codec.compress(torch.from_numpy(x), quality=q)
    assert abs(ours["num_bytes"] - theirs["num_bytes"]) <= 0.01 * theirs["num_bytes"]
    assert codec.serialize(ours)[5:] == jax_codecs[groups].serialize(theirs)[5:]


def _kept(codec, x, q, rep=None):
    """(the enhancement's keep flags, the container) of one compress."""
    kept = []
    orig = codec.model.codec_prog_params

    def spy(*args):
        out = orig(*args)
        kept.append(out[4])
        return out

    codec.model.codec_prog_params = spy
    try:
        data = codec.compress(x, quality=q, checkpoint_rep=rep)
    finally:
        del codec.model.codec_prog_params
    return torch.cat(kept, dim=-1), data


def test_rem_banks_are_live(setup):
    """The quantile fixes how many elements q=1.0 keeps; the banks move
    which ones, and so the bytes."""
    model, _ = setup
    identity = get_model(CFG, device="cpu")
    sd = live_rem_weights(CFG)
    identity.load_state_dict({k: torch.zeros_like(v) if "zero_out" in k else v
                              for k, v in sd.items()}, strict=True)
    x = torch.from_numpy(image(32))
    live = make_codec(model, lanes=64, device="cpu")
    keep_live, data_live = _kept(live, x, 1.0)
    keep_id, data_id = _kept(make_codec(identity, lanes=64, device="cpu"), x, 1.0)
    assert not torch.equal(keep_live, keep_id)
    assert data_live["num_bytes"] != data_id["num_bytes"]
    rep = torch.from_numpy(
        np.random.default_rng(33).standard_normal((1, 4, 4, 4 * CFG.dim_chunk)).astype(np.float32))
    assert _kept(live, x, 1.0, rep)[1]["num_bytes"] != data_live["num_bytes"]


@pytest.mark.parametrize("groups", [1, 2])
def test_escalation_roundtrip_bit_exact(setup, groups):
    model, _ = setup
    codec = make_codec(model, lanes=64, groups=groups, device="cpu")
    data = rem.escalation_compress(codec, torch.from_numpy(image(34)), quality=10.0)
    assert [d["quality"] for d in data["checkpoints"]] == [
        float(np.float32(q)) for q in CFG.check_levels]
    sent = {"checkpoints": [through_container(codec, d) for d in data["checkpoints"]],
            "final": through_container(codec, data["final"])}
    out = rem.escalation_decompress(codec, sent)
    assert out["stream_ok"]
    assert len(out["anchors"]) == len(data["anchors"]) == 3
    for ours, theirs in zip(out["anchors"], data["anchors"]):
        assert torch.equal(ours, theirs)
    assert torch.equal(out["y_hat"], data["final"]["y_hat"])
    assert torch.equal(out["x_hat"], data["final"]["x_hat"])
    # the cascade's final stream differs from a plain one at the same quality
    plain = codec.serialize(codec.compress(torch.from_numpy(image(34)), quality=1.0))
    cascaded = rem.escalation_compress(codec, torch.from_numpy(image(34)), quality=1.0)
    assert len(cascaded["checkpoints"]) == 2
    assert codec.serialize(cascaded["final"]) != plain


@pytest.mark.parametrize("q", [0.005, 0.01])
def test_escalation_at_or_below_the_first_checkpoint(setup, q):
    model, _ = setup
    codec = make_codec(model, lanes=64, device="cpu")
    data = rem.escalation_compress(codec, torch.from_numpy(image(35)), quality=q)
    assert data["checkpoints"] == [] and data["anchors"] == []
    out = rem.escalation_decompress(codec, {"checkpoints": [],
                                            "final": through_container(codec, data["final"])})
    assert out["stream_ok"] and torch.equal(out["y_hat"], data["final"]["y_hat"])


def test_fractional_quality_is_coded_at_the_container_value(setup):
    model, _ = setup
    codec = make_codec(model, lanes=64, device="cpu")
    data = codec.compress(torch.from_numpy(image(36)), quality=0.58, simulate=True)
    back = through_container(codec, data)
    assert data["quality"] == back["quality"] == float(np.float32(0.58))
    out = codec.decompress(back)
    assert out["stream_ok"] and torch.equal(out["y_hat"], data["y_hat"])
