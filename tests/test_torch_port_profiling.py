"""PyTorch port: phase timers, device traces, FLOP counting and MFU.

  * the blocking recorder (`recording(sync=True)`), the port's stand-in for
    JAX's `PhaseTimer`: each span is counted and timed, a span that raises
    still closes, a span's own time is its duration less its children's,
    and on the CPU the syncs are no-ops;
  * `device_trace` writes a Chrome trace on the CPU that names the ops run;
  * `count_flops` of TINY's `forward_single_quality` (N=32, M=64, dim_chunk
    8, 64x64, q in {0, 10}) against JAX's `count_flops` of the same forward,
    by an exact relation.  JAX computes a transposed convolution as a
    convolution of the input dilated by the stride s, and counts the s^2
    inserted zeros' products too; the port counts the transposed
    convolution's own work.  Walking JAX's jaxpr splits its count into the
    lhs-dilated convolutions and the rest: the port's transposed
    convolutions times s^2 equal the former, and its other convolutions
    and products equal the latter (GDN's channel mixing is a 1x1
    convolution in the port and a dot_general in JAX, so the two are
    compared as one sum).  Nothing is compiled: JAX traces only;
  * `chip_peak_flops` for both H100 names, float32 with TF32 off, and a
    raise for another card; `mfu` = flops / (seconds * peak).
"""

import json
import time
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive
from progressivecodec_tpu.utils import flops as jax_flops

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.utils import flops
from progressivecodec_tpu_torch.utils import profiling
from progressivecodec_tpu_torch.utils.profiling import TRACE_FILE, device_trace

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))


def test_phase_timer():
    t = time.time_ns()
    with profiling.recording(sync=True):
        for _ in range(3):
            with profiling.span("a"):
                torch.ones(8).sum()
        with profiling.span("b"):
            with profiling.span("a"):
                pass
        with pytest.raises(ValueError):
            with profiling.span("c"):
                raise ValueError("the span still closes")
    assert not profiling.on() and profiling.open_spans() == []
    recs = [s for s in profiling.spans() if s.t0_ns >= t]
    assert Counter(s.name for s in recs) == {"a": 4, "b": 1, "c": 1}
    b = next(s for s in recs if s.name == "b")
    (inner,) = [s for s in recs if s.parent == b.id]
    assert inner.name == "a" and inner.call == b.call == b.id
    assert profiling.self_ns(recs)[b.id] == (b.t1_ns - b.t0_ns) - (inner.t1_ns - inner.t0_ns)
    assert all(s.t1_ns > s.t0_ns for s in recs if s is not inner)


def test_device_trace_on_the_cpu(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    with device_trace(str(tmp_path / "trace")) as prof:
        conv(torch.ones(1, 3, 8, 8))
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::conv2d" in names
    assert any(e.key == "aten::conv2d" for e in prof.key_averages())


def split_jax_flops(jaxpr, mult=1):
    """(lhs-dilated convolution FLOPs, the port's count of the same
    transposed convolutions, every other FLOP) of a jaxpr, walked as JAX's
    `count_flops` walks it."""
    dilated = transposed = other = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        subs = []
        if name == "conv_general_dilated":
            n = mult * jax_flops._conv_flops(eqn)
            s2 = int(np.prod(eqn.params["lhs_dilation"]))
            if s2 > 1:
                dilated += n
                transposed += n // s2
            else:
                other += n
        elif name == "dot_general":
            other += mult * jax_flops._dot_flops(eqn)
        elif name in ("scan", "while", "cond"):
            raise AssertionError(f"unexpected {name} in the forward")
        else:
            subs = [eqn.params.get(k) for k in ("jaxpr", "call_jaxpr")]
        for sub in subs:
            if sub is not None:
                d, t, o = split_jax_flops(getattr(sub, "jaxpr", sub), mult)
                dilated, transposed, other = dilated + d, transposed + t, other + o
    return dilated, transposed, other


@pytest.fixture(scope="module")
def tiny():
    sd = init_params(CFG, torch.Generator().manual_seed(51))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    x = np.random.default_rng(52).random((1, 64, 64, 3)).astype(np.float32)
    return model, params, x


@pytest.mark.parametrize("q", [0.0, 10.0])
def test_count_flops_against_jax(tiny, q):
    model, params, x = tiny
    jmodel = JaxModel(cfg=JCFG)

    def jax_forward(v, xx):
        return jmodel.apply(v, xx, q, "point-based-std", training=False,
                            method=JaxModel.forward_single_quality)

    args = ({"params": params}, jnp.asarray(x))
    jax_total = jax_flops.count_flops(jax_forward, *args)
    dilated, transposed, other = split_jax_flops(jax.make_jaxpr(jax_forward)(*args).jaxpr)
    assert dilated + other == jax_total and dilated > 0

    with torch.no_grad():
        fwd = lambda xx: model.forward_single_quality(xx, q, "point-based-std")  # noqa: E731
        kinds = flops.flops_by_kind(fwd, torch.from_numpy(x))
        total = flops.count_flops(fwd, torch.from_numpy(x))
    assert total == sum(kinds.values())
    assert kinds["conv_transpose"] * 4 == dilated  # every deconvolution has stride 2
    assert kinds["conv_transpose"] == transposed
    assert kinds["conv"] + kinds["matmul"] == other
    print(f"q={q}: port {total} FLOPs {kinds}; JAX {jax_total}")


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 66.9e12),
                                       ("NVIDIA H100 PCIe", 51.2e12),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_chip_peak_flops_and_mfu(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    if peak is None:
        with pytest.raises(ValueError, match="no float32 peak"):
            flops.chip_peak_flops()
        with pytest.raises(ValueError):
            flops.mfu(1e12, 1.0)
        return
    got, note = flops.chip_peak_flops()
    assert got == peak and "float32" in note and "TF32 off" in note
    assert flops.mfu(peak * 0.25 * 3.0, 3.0) == pytest.approx(0.25)
