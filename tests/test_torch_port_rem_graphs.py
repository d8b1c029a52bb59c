"""PyTorch port: CUDA graphs of REM's unrolled enhancement (`models/graphs.py`).

On the CPU (TINY: N=32, M=64, dim_chunk 8, division (32, 64), 64x64 images,
64 lanes, live banks), with a capture backend injected in place of the CUDA
one (`Emulated`: a "graph" reruns its unit on the captured buffers and
writes the captured outputs, so the codec meets a graph's fixed buffers):
  * the engagement rule: no graph on the CPU with the CUDA backend, under
    grad or in training; a shape's first loop runs eagerly, its second
    captures every unit (the banks of every checkpoint interval, whatever
    the quality), later loops replay; the least recently used shape goes
    past the bound; weights loaded anew or tables built anew drop the graphs;
  * graphed round trips equal eager ones: containers byte for byte, y_hat
    and x_hat bit for bit (the simulated ones too), at q in {0.005, 0.1,
    1.0, 5.3, 10} and through the escalation cascade;
  * no output aliases a graph's buffer: a second request leaves the first
    request's outputs as they were;
  * a flagship (stacked) and an STF round trip count no `graph:*` event,
    and the forwards stay eager beside a codec holding graphs.
On the card (marked `cuda`), with the CUDA backend: graphed against eager
REM round trips at TINY and with the full REM at 768x512, q in {0, 0.005,
0.1, 1.0, 5.3, 10}, and one escalation round trip, byte- and bit-identical;
`graph:capture` only on a shape's second loop, `graph:replay` after; a
second request leaves the first's outputs unchanged.

This file imports no JAX, so the card runs it:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_rem_graphs.py`.
"""

from __future__ import annotations

import pytest
import torch

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models import graphs, rem
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.ops.noise import NoiseSource
from progressivecodec_tpu_torch.utils import profiling

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
               scale_table=ScaleTableConfig(levels=32))
TINY_REM = ModelConfig(name="rate", **TINY_KW)
QUALITIES = [0.005, 0.1, 1.0, 5.3, 10.0]
COUNTERS = ("graph:capture", "graph:replay", "graph:eager")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Emulated:
    """A capture backend for the CPU: a unit's "graph" reruns it on the
    captured arguments and copies the results into the captured outputs."""

    def supports(self, device) -> bool:
        return True

    def pool(self):
        return None

    def capture(self, fn, args, pool):
        out = fn(*args)

        def replay():
            for o, n in zip(graphs._leaves((out,), []), graphs._leaves((fn(*args),), [])):
                o.copy_(n)

        return replay, out


class Never:
    """A capture backend that supports no device: every loop eager."""

    def supports(self, device) -> bool:
        return False


def rem_codec(cfg=TINY_REM, device="cpu", backend=None, lanes=64, std=0.1) -> GranularCodec:
    """REM with the port's seeded weights and every bank's zero_out drawn
    from N(0, std^2), so that each bank moves sigma."""
    sd = init_params(cfg, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for k in sd:
        if k.endswith("zero_out.weight"):
            sd[k] = std * torch.randn(sd[k].shape, generator=g, dtype=torch.float32)
    model = get_model(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    codec = GranularCodec(model, lanes=lanes, device=device)
    if backend is not None:
        codec.graphs.backend = backend
    codec.update()
    return codec


def image(seed: int, h: int = 64, w: int = 64, device="cpu") -> torch.Tensor:
    # float32 whatever the worker's default dtype (some JAX-side test files set float64)
    return torch.rand((1, h, w, 3), generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float32).to(device)


def counted(fn):
    """(fn(), the graph counters it added)."""
    before = profiling.totals()
    out = fn()
    after = profiling.totals()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


def round_trip(codec, x, q) -> dict:
    enc = codec.compress(x, quality=q, simulate=True)
    blob = codec.serialize(enc)
    dec = codec.decompress(codec.deserialize(blob))
    assert dec["stream_ok"]
    return {"blob": blob, "sim_y_hat": enc["y_hat"], "sim_x_hat": enc["x_hat"],
            "y_hat": dec["y_hat"], "x_hat": dec["x_hat"]}


def assert_same(a: dict, b: dict) -> None:
    assert a["blob"] == b["blob"]
    for k in ("sim_y_hat", "sim_x_hat", "y_hat", "x_hat"):
        assert torch.equal(a[k], b[k]), k


def units_per_loop(codec, q: float) -> int:
    """Units one loop runs: each slice's parameters and reconstruction, and
    its bank above the first checkpoint."""
    n = codec.cfg.num_prog_slices
    banks = n if rem._f32(q) > rem._f32(codec.cfg.check_levels[0]) else 0
    return 2 * n + banks


def graphs_per_shape(codec) -> int:
    n = codec.cfg.num_prog_slices
    return 2 * n + n * len(codec.cfg.check_levels)


@pytest.fixture(scope="module")
def pair():
    """(an eager codec, a graphed one) on the same weights."""
    return rem_codec(), rem_codec(backend=Emulated())


# ---------------------------------------------------------------- the CPU


def test_no_graph_on_the_cpu_with_the_cuda_backend():
    codec = rem_codec()
    _, n = counted(lambda: [round_trip(codec, image(1), 5.0) for _ in range(2)])
    assert n == {"graph:capture": 0, "graph:replay": 0,
                 "graph:eager": 4 * units_per_loop(codec, 5.0)}
    assert codec.graphs.shapes() == {}


def test_no_graph_under_grad_or_in_training():
    codec = rem_codec(backend=Emulated())
    m, lm = codec.model, torch.zeros((1, 4, 4, 64), dtype=torch.float32)
    with torch.no_grad():
        assert codec.graphs.units(m, lm) is graphs.COUNTED_EAGER
        m.train()
        assert codec.graphs.units(m, lm) is graphs.COUNTED_EAGER
        m.eval()
        with torch.enable_grad():
            assert codec.graphs.units(m, lm) is graphs.COUNTED_EAGER
        assert isinstance(codec.graphs.units(m, lm), graphs.ShapeGraphs)


@pytest.mark.parametrize("q", [0.005, 5.3])
def test_second_loop_captures_every_interval(q):
    codec = rem_codec(backend=Emulated())
    x = image(2)
    enc, first = counted(lambda: codec.compress(x, quality=q))
    assert first == {"graph:capture": 0, "graph:replay": 0,
                     "graph:eager": units_per_loop(codec, q)}
    _, second = counted(lambda: codec.decompress(enc))
    # every bank is captured, also where q's own interval needs none
    assert second == {"graph:capture": graphs_per_shape(codec),
                      "graph:replay": units_per_loop(codec, q), "graph:eager": 0}
    for later in (0.1, 1.0, 10.0):
        _, n = counted(lambda: round_trip(codec, x, later))
        assert n == {"graph:capture": 0, "graph:replay": 2 * units_per_loop(codec, later),
                     "graph:eager": 0}


def test_graphs_engage_through_an_injected_backend():
    calls = []

    class Recording(Emulated):
        def capture(self, fn, args, pool):
            calls.append(fn.__name__)
            return super().capture(fn, args, pool)

    codec = rem_codec(backend=Recording())
    for _ in range(2):
        codec.compress(image(3), quality=1.0)
    n = codec.cfg.num_prog_slices
    assert sorted(set(calls)) == ["_bank", "_prog_recon", "_prog_slice_nhwc"]
    assert calls.count("_bank") == n * len(codec.cfg.check_levels)
    assert calls.count("_prog_slice_nhwc") == calls.count("_prog_recon") == n


@pytest.mark.parametrize("q", QUALITIES)
def test_graphed_round_trip_equals_eager(pair, q):
    eager, graphed = pair
    x = image(5)
    for _ in range(2):  # the shape's first and capturing loops
        round_trip(graphed, x, 5.0)
    got, n = counted(lambda: round_trip(graphed, x, q))
    assert n["graph:eager"] == 0 and n["graph:replay"] == 2 * units_per_loop(graphed, q)
    assert_same(got, round_trip(eager, x, q))


def test_graphed_escalation_equals_eager(pair):
    eager, graphed = pair
    x = image(6)
    out = []
    for codec in (eager, graphed):
        codec.compress(x, quality=5.0)
        data = rem.escalation_compress(codec, x, 10.0)
        dec = rem.escalation_decompress(codec, data)
        assert dec["stream_ok"]
        out.append((data, dec))
    (de, oe), (dg, og) = out
    blobs = lambda d: [eager.serialize(c) for c in d["checkpoints"] + [d["final"]]]  # noqa: E731
    assert blobs(de) == blobs(dg)
    for a, b in zip(de["anchors"] + oe["anchors"], dg["anchors"] + og["anchors"]):
        assert torch.equal(a, b)
    for k in ("x_hat", "y_hat"):
        assert torch.equal(de["final"][k], dg["final"][k]) and torch.equal(oe[k], og[k])


def test_outputs_alias_no_graph_buffer(pair):
    _, graphed = pair
    for _ in range(2):
        round_trip(graphed, image(7), 5.0)
    first = round_trip(graphed, image(8), 5.0)
    kept = {k: v.clone() for k, v in first.items() if k != "blob"}
    anchors = rem.escalation_compress(graphed, image(8), 5.0)["anchors"]
    kept_anchors = [a.clone() for a in anchors]
    round_trip(graphed, image(9), 5.0)
    rem.escalation_compress(graphed, image(9), 5.0)
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(anchors, kept_anchors))


def test_least_recently_used_shape_goes_past_the_bound():
    codec = rem_codec(backend=Emulated())
    codec.graphs.max_shapes = 2
    a, b, c = image(10, 64, 64), image(10, 64, 128), image(10, 128, 64)
    for x in (a, a, b, c):
        codec.compress(x, quality=1.0)
    shapes = codec.graphs.shapes()
    assert list(shapes.values()) == [False, False]
    assert [k[0][1:3] for k in shapes] == [(4, 8), (8, 4)]
    _, n = counted(lambda: codec.compress(a, quality=1.0))
    assert n["graph:replay"] == 0 and n["graph:eager"] == units_per_loop(codec, 1.0)


def test_new_weights_drop_the_graphs():
    codec = rem_codec(backend=Emulated())
    x = image(11)

    def captured():
        for _ in range(2):
            codec.compress(x, quality=1.0)
        assert list(codec.graphs.shapes().values()) == [True]

    captured()
    codec.update()
    assert list(codec.graphs.shapes().values()) == [True]
    codec.model.load_state_dict(codec.model.state_dict(), strict=True)
    assert codec.graphs.shapes() == {}
    captured()
    codec.update(force=True)
    assert codec.graphs.shapes() == {}
    _, n = counted(lambda: codec.compress(x, quality=1.0))
    assert n["graph:replay"] == 0


@pytest.mark.parametrize("name", ["channel", "stf"])
def test_stacked_and_single_rate_round_trips_count_no_graph_event(name):
    cfg = ModelConfig(name=name, **TINY_KW)
    torch.manual_seed(3)
    model = get_model(cfg, device="cpu")  # the modules' own init
    codec = GranularCodec(model, lanes=64, device="cpu")
    codec.graphs.backend = Emulated()
    _, n = counted(lambda: [round_trip(codec, image(12), q) for q in (5.0, 5.0, 10.0)])
    assert n == {k: 0 for k in COUNTERS}
    assert codec.graphs.shapes() == {}


def test_forwards_stay_eager_beside_graphs(pair):
    _, graphed = pair
    for _ in range(2):
        graphed.compress(image(13), quality=5.0)
    m, x = graphed.model, image(13)
    with torch.no_grad():
        _, n = counted(lambda: m.forward_single_quality(x, 5.0))
    assert n == {k: 0 for k in COUNTERS}
    m.train()
    try:
        _, n = counted(lambda: m(x, [0.0, 5.0], training=True, noise=NoiseSource.seeded(1)))
    finally:
        m.eval()
    assert n == {k: 0 for k in COUNTERS}


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graphs run there only")
    return torch.device("cuda")


def graphed_against_eager(cfg, card, x, lanes, std):
    eager = rem_codec(cfg, card, backend=Never(), lanes=lanes, std=std)
    graphed = rem_codec(cfg, card, lanes=lanes, std=std)
    _, first = counted(lambda: graphed.compress(x, quality=5.3))
    assert first["graph:capture"] == 0
    _, second = counted(lambda: round_trip(graphed, x, 5.3))
    assert second["graph:capture"] == graphs_per_shape(graphed)
    for q in [0.0] + QUALITIES:
        got, n = counted(lambda: round_trip(graphed, x, q))
        assert n == {"graph:capture": 0, "graph:replay": 2 * units_per_loop(graphed, q) * (q > 0),
                     "graph:eager": 0}, q
        want = round_trip(eager, x, q)
        assert_same(got, want)
    return eager, graphed


@pytest.mark.cuda
def test_card_graphed_round_trips_equal_eager_tiny(card):
    graphed_against_eager(TINY_REM, card, image(20, device=card), 64, 0.1)


@pytest.mark.cuda
def test_card_graphed_round_trips_equal_eager_kodak(card):
    """The full REM (N 192, M 640, ten enhancement slices, 30 banks) at
    768x512, zero_out at the benchmark's std 0.02, 512 lanes."""
    x = image(21, 512, 768, device=card)
    eager, graphed = graphed_against_eager(ModelConfig(name="rate"), card, x, 512, 0.02)
    out = []
    for codec in (eager, graphed):
        data = rem.escalation_compress(codec, x, 10.0)
        dec = rem.escalation_decompress(codec, data)
        assert dec["stream_ok"]
        out.append(([codec.serialize(c) for c in data["checkpoints"] + [data["final"]]],
                    data["anchors"] + dec["anchors"], dec))
    (be, ae, oe), (bg, ag, og) = out
    assert be == bg
    assert all(torch.equal(a, b) for a, b in zip(ae, ag))
    assert torch.equal(oe["x_hat"], og["x_hat"]) and torch.equal(oe["y_hat"], og["y_hat"])


@pytest.mark.cuda
def test_card_outputs_alias_no_graph_buffer(card):
    codec = rem_codec(TINY_REM, card)
    for _ in range(2):
        round_trip(codec, image(22, device=card), 5.0)
    first = round_trip(codec, image(23, device=card), 5.0)
    kept = {k: v.clone() for k, v in first.items() if k != "blob"}
    _, n = counted(lambda: round_trip(codec, image(24, device=card), 5.0))
    assert n["graph:replay"] == 2 * units_per_loop(codec, 5.0)
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
