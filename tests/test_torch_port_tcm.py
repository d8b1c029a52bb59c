"""TCM, the mixed Transformer-CNN codec ("tcm"), against its plain reference.

The reference is the benchmark's, `benchmark/reference/tcm.py`, loaded by
path as the benchmark's harness loads it; the weights are the benchmark's
seeded draw at a TINY size (N 32, M 40, dim_chunk 8: the published head
widths give 4-2-1 heads; z keeps its 192 channels, SWAtten its 128; 32 scale
levels):
  * the port's g_a and g_s equal the reference's bit for bit, at 256x256
    and 256x384;
  * one round trip through `GranularCodec` (compress, serialize,
    deserialize, decompress) gives the reference's container bytes, its
    decoded latent and its reconstruction (within the benchmark's limit);
  * at N 128, M 320 the port's state-dict names, shapes and parameter count
    are the reference's `param_spec` and the configuration file's
    `parameters`, and the file's "tcm" entry is TCM's constants;
  * a round trip records one `tcm:ctb` span per block, `tcm:res` spans, a
    `swatten:mean` and a `swatten:scale` span per slice and side, and
    counts the windows attended;
  * an image whose sides are not multiples of 128 (or are 128) is refused;
  * z's width is read from the model: 192 for TCM, N for the others;
  * a TCM checkpoint with CompressAI's buffers loads through `load_pth`.
"""

import importlib.util
import json
import math
import pathlib
import sys

import pytest
import torch

from benchmark import compare, weights
from benchmark.reference import coder

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec import _stream_capacity
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.tcm import DEPTHS, TCM, Z_CHANNELS
from progressivecodec_tpu_torch.models.transforms import nchw
from progressivecodec_tpu_torch.models.weights import REFERENCE_BUFFERS, load_pth
from progressivecodec_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "benchmark" / "configs" / "tcm.json").read_text())
TINY = {"name": "tcm", "N": 32, "M": 40, "dim_chunk": 8, "scale_table": {"min": 0.11, "max": 256.0, "levels": 32}}
CFG = ModelConfig(name="tcm", N=32, M=40, dim_chunk=8, scale_table=ScaleTableConfig(levels=32))
LANES = 64
SIZES = [(256, 256), (256, 384)]


def _reference():
    name = "benchmark_reference_tcm"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / "benchmark" / "reference" / "tcm.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ref = _reference()
    rc = ref.Cfg(TINY)
    P = weights.draw_weights(ref.param_spec(rc), CONF["weights_seed"], "cpu", CONF["init"], ref.INIT_KINDS)
    model = get_model(CFG, device="cpu")
    model.load_state_dict(P, strict=True)
    codec = GranularCodec(model, lanes=LANES, device="cpu")
    return ref, rc, P, model, codec


def _image(h, w, seed=3):
    # float32 whatever the process's default dtype (some JAX-side test files
    # set float64 in the worker this file may share)
    return torch.rand((1, h, w, 3), generator=torch.Generator().manual_seed(seed), dtype=torch.float32)


@pytest.mark.parametrize("h,w", SIZES)
def test_transforms_equal_the_reference(setup, h, w):
    ref, rc, P, model, _ = setup
    x = _image(h, w)
    with torch.no_grad():
        y = model.analyze(x)
        y_ref = ref.g_a(P, rc, nchw(x))
        assert y.shape == (1, h // 16, w // 16, 40) and torch.equal(nchw(y), y_ref)
        x_hat = model.synthesize(y)
        assert x_hat.shape == (1, h, w, 3) and torch.equal(nchw(x_hat), ref.g_s(P, rc, y_ref))


@pytest.mark.parametrize("h,w", SIZES)
def test_round_trip_equals_the_reference(setup, h, w):
    ref, rc, P, _, codec = setup
    x = _image(h, w, seed=h + w)
    blob = codec.serialize(codec.compress(x, quality=0.0))
    out = codec.decompress(codec.deserialize(blob))
    assert out["stream_ok"]
    r = ref.reference_request(P, rc, x, 0.0)
    assert len(r["stages"]) == 1 + 40 // 8
    assert r["stages"][0][0].numel() == (h // 64) * (w // 64) * Z_CHANNELS
    eb = {k.split(".")[-1]: v.numpy() for k, v in P.items() if "entropy_bottleneck" in k}
    tables = coder.Tables(eb, rc.scale_table)
    nums = compare.compare(r, blob, out["x_hat"], out["y_hat"], tables, LANES, 1, 0.0, CFG.mask_policy)
    assert len(blob) == nums["ref_bytes"] and nums["z_mismatch"] == 0
    assert torch.equal(out["y_hat"], r["y_hat"])
    assert nums["xhat_rel_l2"] <= compare.LIMITS["xhat_rel_l2"]


def test_sizes_and_names_at_the_published_widths():
    cfg = ModelConfig(**{k: v for k, v in CONF["model"].items() if k not in ("tcm", "scale_table")})
    assert (cfg.N, cfg.M, cfg.dim_chunk, cfg.max_support_slices) == (128, 320, 64, 5)
    ref = _reference()
    rc = ref.Cfg(CONF["model"])
    assert rc.tcm == CONF["model"]["tcm"] and rc.N == Z_CHANNELS == 192
    spec = ref.param_spec(rc)
    model = get_model(cfg, device="meta")
    assert isinstance(model, TCM)
    sd = model.state_dict()
    assert list(sd) == [n for n, _, _ in spec]
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, _ in spec)
    assert sum(v.numel() for v in sd.values()) == sum(math.prod(s) for _, s, _ in spec) == CONF["parameters"]
    # 2N = 256 channels in the blocks, heads 16-8-4 in g_a, z 192, SWAtten 320 + 64 i -> 128
    assert sd["g_a.1.conv1_1.weight"].shape == (256, 256, 1, 1)
    assert sd["g_a.1.trans_block.msa.relative_position_params"].shape == (16, 15, 15)
    assert sd["g_a.7.trans_block.msa.relative_position_params"].shape == (4, 15, 15)
    assert sd["h_a.3.weight"].shape == (192, 256, 3, 3)
    assert sd["atten_scale.4.0.in_conv.weight"].shape == (128, 576, 1, 1)
    assert sd["lrp_transforms.4.4.weight"].shape == (64, 128, 3, 3)


def test_round_trip_spans_and_windows(setup):
    _, _, _, _, codec = setup
    x = _image(256, 256)
    n0, w0 = len(profiling.spans()), profiling.total("tcm:windows")
    with profiling.recording():
        blob = codec.serialize(codec.compress(x, quality=0.0))
        assert codec.decompress(codec.deserialize(blob))["stream_ok"]
    names = [s.name for s in profiling.spans()[n0:]]
    blocks = sum(DEPTHS[:3])
    # compress: g_a, h_a, both hyper syntheses; decompress: both hyper
    # syntheses and g_s
    assert names.count("tcm:ctb") == blocks + 2 + 2 * 2 + 2 * 2 + blocks
    assert names.count("tcm:res") == 3 + 1 + 2 + 2 + 3 + 1
    assert names.count("swatten:mean") == names.count("swatten:scale") == 2 * 5
    # windows of 8 at 128, 64, 32 (g_a / g_s) and 16 (SWAtten, 2 blocks),
    # of 4 at 8 (the hyperprior); per side
    g = 2 * (16 * 16 + 8 * 8 + 4 * 4)
    per_side = g + 2 * 5 * 2 * 4 + 2 * 4 * 2
    assert profiling.total("tcm:windows") - w0 == 2 * per_side + 2 * 4


@pytest.mark.parametrize("h,w", [(200, 200), (256, 320), (128, 256)])
def test_images_off_the_grid_are_refused(setup, h, w):
    _, _, _, model, codec = setup
    with pytest.raises(ValueError, match="multiples of 128"):
        codec.compress(_image(h, w), quality=0.0)
    with pytest.raises(ValueError, match="multiples of 128"):
        model(_image(h, w))


def test_z_width_comes_from_the_model(setup):
    *_, codec = setup
    assert codec._z_channels == Z_CHANNELS
    others = [ModelConfig(), ModelConfig(name="cnn", N=32, M=64, dim_chunk=8),
              ModelConfig(name="stf", N=32, M=64, dim_chunk=8)]
    for cfg in others:
        model = get_model(cfg, device="meta")
        assert model.entropy_bottleneck.channels == cfg.N
    # the capacity of a container keeps its bound where z has N channels
    cfg = ModelConfig(name="stf", N=192, M=384)
    hy, wy = 64, 128
    old = 2 * 512 + sum(-(-n // 512) * 512 for n in [16 * 32 * 192] + [hy * wy * 32] * 12)
    assert _stream_capacity(1, (16, 32), cfg.N, cfg, 512) == old


def test_tcm_checkpoint_loads(tmp_path):
    """A state dict named as TCM's `param_spec`, with CompressAI's buffers of
    the entropy models and GDNs, loads through `load_pth` with strict=True."""
    ref = _reference()
    spec = ref.param_spec(ref.Cfg(TINY))
    sd = {f"module.{n}": torch.zeros(s) for n, s, _ in spec}
    for n, _, _ in spec:
        if n.endswith(".gamma"):
            p = n[: -len("gamma")]
            for b in ("beta_reparam.pedestal", "beta_reparam.lower_bound.bound",
                      "gamma_reparam.pedestal", "gamma_reparam.lower_bound.bound"):
                sd[f"module.{p}{b}"] = torch.zeros(())
    for b in ("_offset", "_quantized_cdf", "_cdf_length", "likelihood_lower_bound.bound", "target"):
        sd[f"module.entropy_bottleneck.{b}"] = torch.zeros(3)
    for b in ("_offset", "_quantized_cdf", "_cdf_length", "likelihood_lower_bound.bound",
              "scale_table", "scale_bound", "lower_bound_scale.bound"):
        sd[f"module.gaussian_conditional.{b}"] = torch.zeros(3)
    assert all(k.endswith(tuple("." + b for b in REFERENCE_BUFFERS)) for k in sd if k[7:] not in
               {n for n, _, _ in spec})
    torch.save({"state_dict": sd}, tmp_path / "tcm.pth")
    got = load_pth(str(tmp_path / "tcm.pth"), CFG)
    assert list(got) == [n for n, _, _ in spec]
    get_model(CFG, device="cpu").load_state_dict(got, strict=True)
