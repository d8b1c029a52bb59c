"""STF, the SymmetricalTransFormer ("stf"), against its plain reference.

The reference is the benchmark's, `benchmark/reference/stf.py`, loaded by
path as the benchmark's harness loads it; the weights are the benchmark's
seeded draw at the TINY sizes (N 32, M 64, dim_chunk 8, 32 scale levels):
  * the port's Swin analysis and synthesis equal the reference's bit for
    bit, at 64x64 and at 59x57, whose stage maps need the patch embedding's
    and the windows' padding and two odd patch merges;
  * one round trip through `GranularCodec` (compress, serialize,
    deserialize, decompress) gives the reference's container bytes, its
    decoded latent and its reconstruction (within the benchmark's limit);
  * the sizes derived from N and M at M 384 are the configuration file's,
    and at those widths the port's state-dict names and parameter count are
    the reference's `param_spec` and the file's `parameters`;
  * a round trip records one `swin:attn` span per block and side and counts
    the windows attended;
  * an STF checkpoint with its relative-position index buffers loads.
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
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.stf import DEPTHS, SymmetricalTransFormer, stf_sizes
from progressivecodec_tpu_torch.models.transforms import nchw
from progressivecodec_tpu_torch.models.weights import load_pth
from progressivecodec_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "benchmark" / "configs" / "stf.json").read_text())
TINY = {"name": "stf", "N": 32, "M": 64, "dim_chunk": 8, "scale_table": {"min": 0.11, "max": 256.0, "levels": 32}}
CFG = ModelConfig(name="stf", N=32, M=64, dim_chunk=8, scale_table=ScaleTableConfig(levels=32))
LANES = 64


def _reference():
    name = "benchmark_reference_stf"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / "benchmark" / "reference" / "stf.py")
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


@pytest.mark.parametrize("h,w", [(64, 64), (59, 57)])
def test_transforms_equal_the_reference(setup, h, w):
    ref, rc, P, model, _ = setup
    x = _image(h, w)
    with torch.no_grad():
        y = model.analyze(x)
        y_ref = ref.g_a(P, rc, nchw(x))
        assert y.shape == (1, 4, 4, 64) and torch.equal(nchw(y), y_ref)
        x_hat = model.synthesize(y)
        assert x_hat.shape == (1, 64, 64, 3) and torch.equal(nchw(x_hat), ref.g_s(P, rc, y_ref))


@pytest.mark.parametrize("h,w", [(64, 128), (59, 57)])
def test_round_trip_equals_the_reference(setup, h, w):
    ref, rc, P, _, codec = setup
    x = _image(h, w, seed=h + w)
    blob = codec.serialize(codec.compress(x, quality=0.0))
    out = codec.decompress(codec.deserialize(blob))
    assert out["stream_ok"]
    r = ref.reference_request(P, rc, x, 0.0)
    assert len(r["stages"]) == 1 + 64 // 8
    eb = {k.split(".")[-1]: v.numpy() for k, v in P.items() if "entropy_bottleneck" in k}
    tables = coder.Tables(eb, rc.scale_table)
    nums = compare.compare(r, blob, out["x_hat"], out["y_hat"], tables, LANES, 1, 0.0, CFG.mask_policy)
    assert len(blob) == nums["ref_bytes"] and nums["z_mismatch"] == 0
    assert torch.equal(out["y_hat"], r["y_hat"])
    assert nums["xhat_rel_l2"] <= compare.LIMITS["xhat_rel_l2"]


def test_sizes_and_names_at_the_published_widths():
    cfg = ModelConfig(**{k: v for k, v in CONF["model"].items() if k not in ("swin", "scale_table")})
    sizes = stf_sizes(cfg)
    assert {k: v for k, v in sizes.items() if k != "hyper"} == CONF["model"]["swin"]
    assert sizes["hyper"] == [384, 336, 288, 240]
    ref = _reference()
    spec = ref.param_spec(ref.Cfg(CONF["model"]))
    sd = get_model(cfg, device="meta").state_dict()
    assert list(sd) == [n for n, _, _ in spec]
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, _ in spec)
    assert sum(v.numel() for v in sd.values()) == sum(math.prod(s) for _, s, _ in spec) == CONF["parameters"]


def test_round_trip_spans_and_windows(setup):
    _, _, _, _, codec = setup
    x = _image(64, 64)
    n0, w0 = len(profiling.spans()), profiling.total("swin:windows")
    with profiling.recording():
        blob = codec.serialize(codec.compress(x, quality=0.0))
        assert codec.decompress(codec.deserialize(blob))["stream_ok"]
    names = [s.name for s in profiling.spans()[n0:]]
    assert names.count("swin:attn") == names.count("swin:mlp") == 2 * sum(DEPTHS)
    assert names.count("swin:merge") == names.count("swin:split") == len(DEPTHS) - 1
    assert names.count("swin:embed") == names.count("swin:end") == 1
    # each side: 8x8 windows twice at 32x32, 4x4 twice at 16x16, 2x2 six
    # times at 8x8, one twice at 4x4
    assert profiling.total("swin:windows") - w0 == 2 * (2 * 64 + 2 * 16 + 6 * 4 + 2 * 1)


def test_stf_checkpoint_loads(tmp_path):
    model = get_model(CFG, device="cpu")
    assert isinstance(model, SymmetricalTransFormer)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    for k in list(sd):
        if k.endswith(".attn.qkv.weight"):
            sd[k.replace("qkv.weight", "relative_position_index")] = torch.zeros(16, 16, dtype=torch.int64)
    torch.save({"state_dict": sd}, tmp_path / "stf.pth")
    got = load_pth(str(tmp_path / "stf.pth"), CFG)
    assert set(got) == set(model.state_dict())
    with pytest.raises(KeyError, match="stf"):
        get_model(ModelConfig(name="swin"), device="cpu")
