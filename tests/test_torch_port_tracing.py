"""PyTorch port: the spans and counters of `utils/profiling.py` inside the
codec, on the CPU at TINY (N=32, M=64, dim_chunk 8, division (32, 64)),
64x64 images, 64 lanes, with the port's seeded weights (`init_params`):
  * spans nest: every span's parent holds it, and the spans of one public
    call (`codec:*` root) share its call id; self time is the duration less
    the children's;
  * a flagship (stacked) and a REM (unrolled) round trip at q in {0, 5, 10}
    record the fragments and coder phases a round trip runs, each the
    expected number of times (1 + ns0 + 1 `coder:decode_stage_scan` at
    q > 0 for the flagship, 1 + ns0 + the enhancement slices for REM);
  * the `words:*` counters sum to the container's `num_bytes`, on the spans
    and in the process-wide totals;
  * with recording off nothing is buffered; with the spans on under the
    profiler the containers equal those of a plain codec byte for byte;
  * the host waits on the card only at the container's four points: a
    round trip records `sync:n_words`, `sync:words_to_host`,
    `sync:words_to_device` and `sync:stream_ok` once each and no other
    `sync:*` span, in both configurations at q in {0, 5, 10}.
On the card (marked `cuda`): in a round trip at q = 5 under
`torch.cuda.set_sync_debug_mode("warn")`, every synchronizing call torch
reports is made inside one of those four spans; REM's round trip there
replays its unrolled enhancement as CUDA graphs (`models/graphs.py`).

This file imports no JAX, so the card runs it:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tracing.py`.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter

import pytest
import torch

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.utils import profiling

TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
               scale_table=ScaleTableConfig(levels=32))
ROOTS = ["codec:compress", "codec:serialize", "codec:deserialize", "codec:decompress"]
CONTAINER_SYNCS = ["sync:n_words", "sync:words_to_host", "sync:words_to_device", "sync:stream_ok"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: set_sync_debug_mode reports CUDA syncs only")
    return torch.device("cuda")


def tiny_codec(name: str, device="cpu") -> GranularCodec:
    cfg = ModelConfig(name=name, **TINY_KW)
    model = get_model(cfg, device=device)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(3)), strict=True)
    codec = GranularCodec(model, lanes=64, device=device)
    codec.update()
    return codec


@pytest.fixture(scope="module")
def codecs():
    return {name: tiny_codec(name) for name in ("channel", "rate")}


def image(seed: int) -> torch.Tensor:
    return torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(seed))


def round_trip(codec, x, q):
    data = codec.compress(x, quality=q)
    blob = codec.serialize(data)
    return data, blob, codec.decompress(codec.deserialize(blob))


def recorded(fn):
    """fn() inside `recording()`: (its result, the spans it recorded)."""
    t = time.time_ns()
    with profiling.recording():
        out = fn()
    return out, [s for s in profiling.spans() if s.t0_ns >= t]


def expected_calls(codec, q: float) -> dict:
    """The fragment and coder-phase spans of one round trip, by name."""
    cfg = codec.cfg
    ns0, n_prog = cfg.ns0, cfg.num_prog_slices
    want = {"frag:analyze": 1, "frag:codec_hyper_enc": 1, "frag:codec_hyper_dec": 2,
            "frag:codec_base_params": 2 * ns0, "frag:codec_base_recon": 2 * ns0,
            "frag:codec_base_step": 2 * (ns0 - 1), "frag:codec_synth": 1,
            "coder:encode_prepare": 1, "coder:encode_scan_rev": 1, "coder:encode_finalize": 1,
            "coder:decoder_init": 1}
    prog_stages = 0
    if q > 0 and codec.model.stacked:
        want.update({"frag:codec_prog_stacked": 2, "frag:codec_prog_recon_stacked": 1})
        prog_stages = 1
    elif q > 0:
        want.update({"frag:codec_prog_params": 2 * n_prog, "frag:codec_prog_recon": 2 * n_prog})
        prog_stages = n_prog
    want["coder:decode_stage_scan"] = want["coder:decode_stage_values"] = 1 + ns0 + prog_stages
    return want


def test_spans_nest_with_one_call_per_public_call(codecs):
    (_, _, out), recs = recorded(lambda: round_trip(codecs["channel"], image(0), 5.0))
    assert out["stream_ok"]
    by_id = {s.id: s for s in recs}
    roots = [s for s in recs if s.parent is None]
    assert sorted(s.name for s in roots) == sorted(ROOTS)
    assert all(s.call == s.id for s in roots)
    for s in recs:
        assert s.t0_ns <= s.t1_ns
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
        assert s.call == p.call
    assert {s.call for s in recs} == {s.id for s in roots}
    # a fragment another fragment calls is its child span
    steps = [s for s in recs if s.name == "frag:codec_base_step"]
    assert steps and all({c.name for c in recs if c.parent == s.id}
                         == {"frag:codec_base_recon", "frag:codec_base_params"} for s in steps)
    assert profiling.open_spans() == []


def test_self_time_is_the_duration_less_the_children(codecs):
    _, recs = recorded(lambda: round_trip(codecs["rate"], image(1), 5.0))
    own = profiling.self_ns(recs)
    for s in recs:
        children = [c for c in recs if c.parent == s.id]
        assert own[s.id] == (s.t1_ns - s.t0_ns) - sum(c.t1_ns - c.t0_ns for c in children)
        assert own[s.id] >= 0
    roots = [s for s in recs if s.parent is None]
    assert sum(own.values()) == sum(s.t1_ns - s.t0_ns for s in roots)


@pytest.mark.parametrize("name", ["channel", "rate"])
@pytest.mark.parametrize("q", [0.0, 5.0, 10.0])
def test_round_trip_records_each_fragment_and_phase(codecs, name, q):
    codec = codecs[name]
    (data, _, out), recs = recorded(lambda: round_trip(codec, image(2), q))
    assert out["stream_ok"]
    got = Counter(s.name for s in recs if s.name.startswith(("frag:", "coder:")))
    assert dict(got) == expected_calls(codec, q)
    names = Counter(s.name for s in recs)
    assert all(names[r] == 1 for r in ROOTS)
    refines = 0 if q == 0 or name == "channel" else codec.cfg.num_prog_slices * 2
    assert names["rem:refine"] == refines
    assert names["sync:n_words"] == names["sync:stream_ok"] == 1


@pytest.mark.parametrize("name", ["channel", "rate"])
@pytest.mark.parametrize("q", [0.0, 5.0, 10.0])
def test_round_trip_waits_only_at_the_container_syncs(codecs, name, q):
    (_, _, out), recs = recorded(lambda: round_trip(codecs[name], image(8), q))
    assert out["stream_ok"]
    syncs = Counter(s.name for s in recs if s.name.startswith("sync:"))
    assert dict(syncs) == {n: 1 for n in CONTAINER_SYNCS}


@pytest.mark.parametrize("name", ["channel", "rate"])
def test_word_counters_equal_the_container(codecs, name):
    codec = codecs[name]
    before = profiling.totals()
    (data, blob, out), recs = recorded(lambda: round_trip(codec, image(4), 7.5))
    words = Counter()
    for s in recs:
        words.update(s.counts)
    assert 2 * (words["words:payload"] + words["words:escape"]) == data["num_bytes"]
    assert words["words:payload"] == data["stream"].numel()
    assert words["words:escape"] == data["esc"].numel()
    after = profiling.totals()
    for k in ("words:payload", "words:escape"):
        assert after.get(k, 0) - before.get(k, 0) == words[k]


def test_spans_off_record_nothing(codecs):
    assert not profiling.on()
    last = profiling.spans()[-1:]
    before = profiling.total("words:payload")
    data, _, out = round_trip(codecs["rate"], image(5), 5.0)
    assert out["stream_ok"]
    assert profiling.spans()[-1:] == last and not profiling.on()
    assert profiling.total("words:payload") - before == data["stream"].numel()


@pytest.mark.parametrize("name", ["channel", "rate"])
def test_containers_equal_with_spans_on(codecs, name):
    codec = codecs[name]
    x = image(6)
    plain = codec.serialize(codec.compress(x, quality=5.0))
    t = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        data, blob, out = round_trip(codec, x, 5.0)
    assert blob == plain and out["stream_ok"]
    recs = [s for s in profiling.spans() if s.t0_ns >= t]
    assert Counter(s.name for s in recs)["coder:decode_stage_scan"] == (
        expected_calls(codec, 5.0)["coder:decode_stage_scan"])
    # each span is a range of the profiler's trace too
    names = Counter(s.name for s in recs)
    ranges = Counter(e.name() for e in prof.profiler.kineto_results.events() if e.name() in names)
    assert ranges == names


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["channel", "rate"])
def test_every_sync_lies_in_a_sync_span(cuda_device, name):
    codec = tiny_codec(name, cuda_device)
    x = image(7).to(cuda_device)
    round_trip(codec, x, 5.0)  # builds the kernels, the decode plans and REM's graphs
    torch.cuda.synchronize()
    before = profiling.totals()
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        seen.append((str(message), profiling.open_spans()))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording():
                _, _, out = round_trip(codec, x, 5.0)
                ok = out["stream_ok"]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [(m, st) for m, st in seen if "called a synchronizing CUDA operation" in m]
    assert ok and syncs, seen
    outside = [st for _, st in syncs if not any(n in CONTAINER_SYNCS for n in st)]
    assert not outside, outside
    # REM's unrolled enhancement ran as CUDA graphs, and they wait on nothing
    after = profiling.totals()
    replays, eager = (after.get(k, 0) - before.get(k, 0) for k in ("graph:replay", "graph:eager"))
    assert (replays > 0 and eager == 0) if name == "rate" else replays == eager == 0
