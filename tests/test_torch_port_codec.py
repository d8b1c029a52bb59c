"""PyTorch port: the codec round trip, against itself and against JAX.

  * port encode -> serialize -> deserialize -> port decode is bit-exact
    (decoded y_hat == the encoder's simulated y_hat) with stream_ok, at
    q in {0, 5, 10} and at batch 2;
  * on the same weights and image, the port's symbols agree with JAX's on
    >= 99.9% of positions, its stream is within 1% of JAX's in bytes, and
    its decoded y_hat is within 2e-4 of JAX's wherever the two chose the
    same symbol;
  * a JAX container is refused by the port's deserialize (ValueError);
  * the port imports neither JAX nor the JAX package, and its entry points
    raise without a card unless asked for the CPU.
"""

import ast
import pathlib

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
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec, make_codec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))


def _image(seed, batch=1):
    return np.random.default_rng(seed).random((batch, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    sd = init_params(CFG, torch.Generator().manual_seed(0))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return GranularCodec(model, lanes=64, device="cpu"), params


def _roundtrip(codec, x, q):
    data = codec.compress(x, quality=q, simulate=True)
    back = codec.deserialize(codec.serialize(data))
    out = codec.decompress(back)
    assert out["stream_ok"], f"q={q}"
    assert torch.equal(out["y_hat"], data["y_hat"]), f"q={q}"
    assert torch.equal(out["x_hat"], data["x_hat"]), f"q={q}"
    assert out["x_hat"].shape == x.shape and bool(torch.isfinite(out["x_hat"]).all())
    return data, out


@pytest.mark.parametrize("q", [0, 5, 10])
def test_port_roundtrip_bit_exact(setup, q):
    codec, _ = setup
    data, _ = _roundtrip(codec, torch.from_numpy(_image(q)), q)
    (stream,), (esc,) = data["streams"], data["escs"]
    assert data["groups"] == 1 and data["num_bytes"] == 2 * (len(stream) + len(esc))


def test_port_batched_roundtrip(setup):
    codec, _ = setup
    _roundtrip(codec, torch.from_numpy(_image(4, batch=2)), 5)


@pytest.mark.parametrize("q", [0, 5])
def test_single_decoder_roundtrip(q):
    cfg = ModelConfig(**TINY_KW, multiple_decoder=False, scale_table=ScaleTableConfig(levels=32))
    model = ChannelProgressiveWACNN(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(2)), strict=True)
    _roundtrip(GranularCodec(model, lanes=64, device="cpu"), torch.from_numpy(_image(40 + q)), q)


def test_port_roundtrip_under_float64_default(setup):
    """Other test files set torch's default dtype to float64 at import; the
    port creates every tensor with an explicit dtype, so it still codes."""
    codec, _ = setup
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        data, out = _roundtrip(codec, torch.from_numpy(_image(6)), 5)
        assert out["y_hat"].dtype == torch.float32
    finally:
        torch.set_default_dtype(prev)


def test_compress_from_latent_escapes_roundtrip(setup):
    codec, _ = setup
    y = torch.from_numpy(80.0 * np.random.default_rng(3).normal(0, 1, (1, 4, 4, CFG.M)))
    data = codec.compress_from_latent(y.to(torch.float32), (1, 64, 64, 3), quality=10,
                                      simulate=True)
    assert len(data["escs"][0]) > 0, "an 80x normal latent must produce escapes"
    back = codec.deserialize(codec.serialize(data))
    np.testing.assert_array_equal(back["escs"][0], data["escs"][0].numpy().view(np.uint16))
    out = codec.decompress(back)
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"])


@pytest.mark.parametrize("q", [0, 10])
def test_auto_lane_policy_roundtrip(setup, q):
    codec, _ = setup
    auto = GranularCodec(codec.model, lanes=256, lane_policy="auto", device="cpu")
    data, _ = _roundtrip(auto, torch.from_numpy(_image(8)), q)
    assert data["lanes"] == 64  # tiny stream -> the header shrank


def _capture_port_stages(monkeypatch):
    seen = []
    orig = rans_device.encode_stages

    def spy(stages, t, lanes, groups=1):
        seen.append([s.numpy() for s, _, _ in stages])
        return orig(stages, t, lanes, groups)

    monkeypatch.setattr(rans_device, "encode_stages", spy)
    return seen


@pytest.fixture(scope="module")
def jax_codec(setup):
    """The JAX codec on the same weights, recording the stages it encodes."""
    _, params = setup
    jcodec = JaxGranularCodec(JaxModel(cfg=JCFG), {"params": params}, lanes=64)
    seen = []
    orig = jcodec._J_encode_for(64)

    def spy(stages):
        seen.append([np.asarray(s) for s, _, _ in stages])
        return orig(stages)

    jcodec._enc_cache[64] = spy
    return jcodec, seen


def _symbol_map(stage_syms, q, y_shape, cfg):
    """Per-stage symbols -> the (B, h, w, C) layout of the decoded y_hat."""
    b, h, w, _ = y_shape
    dc = cfg.dim_chunk
    if q == 0:
        return np.concatenate(
            [s.reshape(b, h, w, dc) for s in stage_syms[1 : 1 + cfg.ns0]], axis=-1
        )
    prog = stage_syms[-1].reshape(cfg.num_prog_slices, b, h, w, dc)
    return prog.transpose(1, 2, 3, 0, 4).reshape(b, h, w, -1)


@pytest.mark.parametrize("q", [0, 5, 10])
def test_port_agrees_with_jax_codec(setup, jax_codec, monkeypatch, q):
    codec, _ = setup
    jcodec, j_seen = jax_codec
    j_seen.clear()
    x = _image(20 + q)
    j_data = jcodec.compress(jnp.asarray(x), quality=q)
    j_out = jcodec.decompress(j_data)
    assert bool(j_out["stream_ok"])
    p_seen = _capture_port_stages(monkeypatch)
    p_data = codec.compress(torch.from_numpy(x), quality=q)
    p_out = codec.decompress(p_data)
    assert p_out["stream_ok"]
    assert abs(p_data["num_bytes"] - j_data["num_bytes"]) <= 0.01 * j_data["num_bytes"]

    j_syms, p_syms = j_seen[0], p_seen[0]
    assert [s.shape for s in j_syms] == [s.shape for s in p_syms]
    agree = np.mean(np.concatenate(j_syms) == np.concatenate(p_syms))
    assert agree >= 0.999, agree

    yj, yp = np.asarray(j_out["y_hat"]), p_out["y_hat"].numpy()
    same = _symbol_map(j_syms, q, yj.shape, CFG) == _symbol_map(p_syms, q, yj.shape, CFG)
    assert same.any()
    assert np.abs(yj - yp)[same].max() <= 2e-4, np.abs(yj - yp)[same].max()


def test_jax_container_refused_by_port(setup, jax_codec):
    codec, _ = setup
    jcodec, _ = jax_codec
    blob = jcodec.serialize(jcodec.compress(jnp.asarray(_image(30)), quality=0))
    with pytest.raises(ValueError, match="magic"):
        codec.deserialize(blob)
    ours = codec.serialize(codec.compress(torch.from_numpy(_image(30)), quality=0))
    with pytest.raises(AssertionError, match="magic"):
        jcodec.deserialize(ours)


@pytest.mark.parametrize("cut", [1, -1])
def test_truncated_or_padded_container_refused(setup, cut):
    codec, _ = setup
    blob = codec.serialize(codec.compress(torch.from_numpy(_image(31)), quality=5))
    bad = blob[:-2] if cut > 0 else blob + b"\0\0"
    with pytest.raises(ValueError, match="container is"):
        codec.deserialize(bad)


@pytest.fixture(scope="module")
def small_data(setup):
    codec, _ = setup
    return codec.compress(torch.from_numpy(_image(32)), quality=0)


@pytest.mark.parametrize("where", ["init", "make_codec", "deserialize", "decompress"])
@pytest.mark.parametrize("lanes", [0, -32, 65536, 100000])
def test_bad_lanes_refused(setup, small_data, where, lanes):
    """The lane counts neither JAX's codec nor the container (a u16) can
    take are refused where they enter, on both the encode side and the
    decode side.  A count outside the u16 cannot be written into a
    container: `serialize` refuses it; a 0 in the header is refused by
    `deserialize`."""
    codec, _ = setup
    with pytest.raises(ValueError, match="lanes"):
        if where == "init":
            GranularCodec(codec.model, lanes=lanes, device="cpu")
        elif where == "make_codec":
            make_codec(codec.model, lanes=lanes, device="cpu")
        elif where == "deserialize":
            codec.deserialize(codec.serialize({**small_data, "lanes": lanes}))
        else:
            codec.decompress({**small_data, "lanes": lanes})


@pytest.mark.parametrize("lanes", [32, 1024])
def test_edge_lanes_roundtrip(setup, lanes):
    codec, _ = setup
    edge = GranularCodec(codec.model, lanes=lanes, device="cpu")
    data, _ = _roundtrip(edge, torch.from_numpy(_image(33)), 5)
    assert data["lanes"] == lanes


def test_entry_points_raise_without_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    codec, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChannelProgressiveWACNN(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GranularCodec(codec.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_codec(codec.model)


@pytest.mark.parametrize("what", ["coder_mesh", "train_mesh", "eval_checkpoint",
                                  "other_model"])
def test_unported_options_raise(setup, what, tmp_path):
    """What the port does at each entry point that it once refused: a
    coder_mesh that is not a DeviceMesh is refused as a wrong argument (the
    sharded coder itself is tests/test_torch_port_sharded_coder.py), and a
    TrainConfig with mesh axes constructs, held and read nowhere, as JAX's
    is.  What it still refuses: a checkpoint of the JAX package (an Orbax
    directory) and a model of no family the codec serves."""
    codec, _ = setup
    if what == "coder_mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            GranularCodec(codec.model, groups=2, coder_mesh=object(), device="cpu")
        return
    if what == "train_mesh":
        from progressivecodec_tpu_torch.config import TrainConfig, to_json, train_config_from_json

        tcfg = TrainConfig(mesh_data=2, mesh_tile=4)
        assert (tcfg.mesh_data, tcfg.mesh_tile) == (2, 4)
        assert train_config_from_json(to_json(tcfg)) == tcfg
        return
    with pytest.raises(NotImplementedError):
        if what == "eval_checkpoint":
            from progressivecodec_tpu_torch.cli import eval as eval_cli

            (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")
            (tmp_path / "config.json").write_text('{"model": {}, "train": {}, "extra": {}}')
            eval_cli.main(["--checkpoint", str(tmp_path), "--synthetic", "--device", "cpu"])
        else:
            GranularCodec(torch.nn.Linear(2, 2), device="cpu")


BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "progressivecodec_tpu"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "progressivecodec_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"])
def test_port_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path} imports {name}"
