"""PyTorch port: the codec tools (`progressivecodec_tpu_torch/tools/`),
against the JAX package's tools/ on the same inputs.

At TINY (N=32, M=64, dim_chunk 8, division (32, 64)) on the port's seeded
weights, carried into JAX's tree by `import_progressive`:
  * profile_codec and the port's spans: the containers made while the
    spans record (the blocking protocol) equal those made without them,
    byte for byte at q in {0, 10}; the outermost `frag:*` spans of a round
    trip count as JAX's tools/profile_codec.ProfiledCodec (loaded by path)
    counts its fragments, and `coder:decode_stage_scan` runs once per stage;
    the trace attribution charges each device event to the innermost phase
    of its launch; `main` runs on the CPU in both modes and writes no
    device metric there;
  * bench_2k: the untiled and the tiled (one-rank gloo mesh) round trips at
    64x128 decode with stream_ok, and the tiled x_hat is within 1e-5 of the
    untiled one's peak (the one tile is the image itself: JAX's layout,
    padded on the right, is not exact there);
  * rd_ladder: a JSONL holding 2 of 4 qualities leads to exactly 2 more
    points, and the final JSON's BD-rate equals JAX's `utils/rd.bd_rate` on
    the same points exactly; a line cut by a kill is skipped;
  * bd_trajectory on the committed runs/*/metrics.jsonl gives JAX's table
    to the last digit;
  * every tool that runs a model raises without a card unless given
    `--device cpu`.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.progressive import ChannelProgressiveWACNN as JaxModel
from progressivecodec_tpu.models.torch_import import import_progressive
from progressivecodec_tpu.utils import rd as jax_rd
from test_torch_port_variants import one_torch_thread, share_jax_compiles  # noqa: F401

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.parallel import tiling
from progressivecodec_tpu_torch.tools import bd_trajectory, bench_2k, profile_codec, rd_ladder
from progressivecodec_tpu_torch.training.checkpoint import save_checkpoint
from progressivecodec_tpu_torch.training.step import init_train_state
from progressivecodec_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))


def jax_tool(name: str):
    """A module of the JAX package's tools/, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image(seed, h=64, w=64):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """(port model, JAX params) on the same seeded weights."""
    sd = init_params(CFG, torch.Generator().manual_seed(0))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = get_model(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model, params


@pytest.fixture(scope="module")
def jax_counts(setup):
    """{q: JAX ProfiledCodec's call counts} over compress(simulate=True) ->
    decompress, the one JAX codec of this file."""
    share_jax_compiles()
    _, params = setup
    codec = jax_tool("profile_codec").ProfiledCodec(JaxModel(cfg=JCFG), {"params": params}, lanes=64)
    counts = {}
    for q in (0, 10):
        codec.timer.counts.clear()
        codec.decompress(codec.compress(jnp.asarray(_image(q)), quality=q, simulate=True))
        counts[q] = dict(codec.timer.counts)
    return counts


# ---------------------------------------------------------------------------
# profile_codec
# ---------------------------------------------------------------------------


def _recorded(fn, sync: bool = False):
    """fn() while the spans record: (its result, the spans it recorded)."""
    t = time.time_ns()
    with profiling.recording(sync=sync):
        out = fn()
    return out, profile_codec.spans_since(t)


@pytest.mark.parametrize("q", [0, 10])
def test_profiled_containers_equal_plain(setup, q):
    model, _ = setup
    x = torch.from_numpy(_image(q))
    codec = GranularCodec(model, lanes=64, device="cpu")
    data, recs = _recorded(lambda: codec.compress(x, quality=q, simulate=True), sync=True)
    blob = codec.serialize(data)
    assert recs and blob == codec.serialize(codec.compress(x, quality=q))
    out, _ = _recorded(lambda: codec.decompress(codec.deserialize(blob)), sync=True)
    assert out["stream_ok"] and torch.equal(out["y_hat"], data["y_hat"])


def outermost_fragments(recs) -> Counter:
    """Calls of each `frag:*` span that no `frag:*` span holds: JAX's rule,
    where a fragment another fragment calls is part of it."""
    by_id = {s.id: s for s in recs}

    def inside_fragment(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name.startswith("frag:"):
                return True
            p = by_id.get(p.parent)
        return False

    return Counter(s.name for s in recs if s.name.startswith("frag:") and not inside_fragment(s))


@pytest.mark.parametrize("q", [0, 10])
def test_fragment_counts_match_jax(setup, jax_counts, q):
    model, _ = setup
    codec = GranularCodec(model, lanes=64, device="cpu")
    x = torch.from_numpy(_image(q))
    _, recs = _recorded(lambda: codec.decompress(codec.compress(x, quality=q, simulate=True)))
    theirs = {k: v for k, v in jax_counts[q].items() if k.startswith("frag:")}
    assert dict(outermost_fragments(recs)) == theirs
    calls = Counter(s.name for s in recs)
    assert calls["coder:decode_stage_scan"] == 1 + CFG.ns0 + (q > 0)
    assert calls["coder:encode_scan_rev"] == 1


def test_grouped_phases(setup):
    """PCT1-G runs the one-stream phases: one prepare, scan and finalize per
    encode, one decoder_init, and per stage one decode scan and one values
    phase over every group; no span of its own."""
    model, _ = setup
    codec = GranularCodec(model, lanes=64, groups=2, device="cpu")
    x = torch.from_numpy(_image(4))
    data = codec.compress(x, quality=10, simulate=True)
    out, recs = _recorded(lambda: codec.decompress(codec.deserialize(codec.serialize(
        codec.compress(x, quality=10)))))
    assert out["stream_ok"] and torch.equal(out["y_hat"], data["y_hat"])
    calls = Counter(s.name for s in recs if s.name.startswith("coder:"))
    assert calls == {"coder:encode_prepare": 1, "coder:encode_scan_rev": 1, "coder:encode_finalize": 1,
                     "coder:decoder_init": 1, "coder:decode_stage_scan": 1 + CFG.ns0 + 1,
                     "coder:decode_stage_values": 1 + CFG.ns0 + 1}
    coder = {s.id for s in recs if s.name.startswith("coder:")}
    assert not any(s.parent in coder for s in recs if s.name.startswith("coder:"))
    assert all(v >= 0 for v in profiling.self_ns(recs).values())


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_trace_attribution_innermost_phase():
    """Device events by the phase range holding their launch: nested ranges
    take the inner one, a launch inside only the round trip is glue, one
    outside it and one without a launch record are not counted; busy is the
    union of the counted intervals."""
    trace = {"traceEvents": [
        _x("round_trip", "user_annotation", 0, 1000),
        _x("codec:compress", "user_annotation", 100, 400),
        _x("coder:encode_scan_rev", "user_annotation", 150, 50),
        _x("frag:analyze", "user_annotation", 600, 100, tid=2),  # another thread
        _x("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 650, 5, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 2000, 5, correlation=4),
        _x("scan", "kernel", 170, 100, tid=7, correlation=1),
        _x("gather", "kernel", 250, 40, tid=7, correlation=2),
        _x("copy", "gpu_memcpy", 700, 10, tid=7, correlation=3),
        _x("late", "kernel", 2010, 10, tid=7, correlation=4),
        _x("orphan", "kernel", 900, 10, tid=7, correlation=9),
    ]}
    names = ["codec:compress", "coder:encode_scan_rev", "frag:analyze"]
    per, busy = profile_codec.attribute_device_time(trace, names)
    assert per == {"coder:encode_scan_rev": (0.1, 1), "codec:compress": (0.04, 1),
                   "glue": (0.01, 1)}
    assert busy == pytest.approx(0.13)  # [170, 290] and [700, 710]


@pytest.mark.parametrize("mode", ["blocking", "trace"])
def test_profile_codec_main_on_cpu(tmp_path, mode, capsys):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(config_lib.to_json(CFG))
    rec = profile_codec.main(["--device", "cpu", "--config", str(cfg_path), "--size", "64x64",
                              "--n", "1", "--lanes", "64", "--mode", mode])
    assert rec["device"] == "cpu" and rec["stream_ok"] and rec["containers_equal_plain"]
    assert "nvidia_smi" not in rec
    assert not any(k in rec for k in ("round_trip_ms", "device_busy_ms", "untraced_round_trip_ms"))
    assert rec["phases"]["frag:analyze"]["calls"] == 1
    assert rec["phases"]["coder:decode_stage_scan"]["calls"] == 1 + CFG.ns0 + 1
    if mode == "blocking":
        assert sum(r["share"] for r in rec["phases"].values()) == pytest.approx(1.0)
    else:
        assert rec["device_time"].startswith("not measured")
    assert json.dumps(rec) in capsys.readouterr().out


# ---------------------------------------------------------------------------
# bench_2k
# ---------------------------------------------------------------------------


def test_bench_2k_tiled_and_untiled_on_one_rank(setup):
    model, _ = setup
    codec = GranularCodec(model, lanes=64, device="cpu")
    x = torch.from_numpy(_image(5, h=64, w=128))
    with bench_2k.one_rank_mesh(torch.device("cpu")) as mesh:
        rec, last = bench_2k.bench(codec, x, mesh, 10.0, 1)
    assert not torch.distributed.is_initialized()
    assert rec["stream_ok"] and rec["shape"] == [64, 128] and rec["device"] == "cpu"
    for key in ("host_untiled_ms_per_image", "host_tiled_mesh1_ms_per_image",
                "host_halo_overhead_pct", "untiled_bytes", "tiled_mesh1_bytes"):
        assert key in rec, key
    assert "untiled_ms_per_image" not in rec
    (_, untiled), (_, tiled) = last["untiled"], last["tiled_mesh1"]
    assert untiled["stream_ok"] and tiled["stream_ok"]
    want = untiled["x_hat"].numpy()
    np.testing.assert_allclose(tiled["x_hat"].numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert rec["tiled_mesh1_bytes"] == rec["untiled_bytes"]


def test_one_rank_tiling_is_the_full_width(setup):
    """The one tile of a one-rank axis holds both image edges, so it runs
    unpadded: the tiled transforms equal the full-width ones bit for bit.
    (Laid out [x | 0 | 0] as JAX lays it, the analysis at 64x256 was 1.46
    from the full width's at a peak of 4.18, over the right half of the
    latent: the Swin shift's windows there took in the zeros.)"""
    model, _ = setup
    x = torch.from_numpy(_image(6, h=64, w=256))
    y = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 4, 16, 32)).astype(np.float32))
    with bench_2k.one_rank_mesh(torch.device("cpu")) as mesh, torch.no_grad():
        assert torch.equal(tiling.tiled_analyze(model, x, mesh), model.analyze(x))
        assert torch.equal(tiling.tiled_synthesize(model, y, mesh, decoder_index=1),
                           nhwc(model.g_s[1](nchw(y))))


# ---------------------------------------------------------------------------
# rd_ladder
# ---------------------------------------------------------------------------


class SmallKodak:
    """Two seeded 192x192 images in SyntheticKodak's place: MS-SSIM's five
    scales fit, and a TINY point takes a fraction of a second."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return _image(70 + i, h=192, w=192)[0]


@pytest.fixture
def checkpoint(setup, tmp_path):
    model, _ = setup
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), init_train_state(model, TrainConfig()), CFG, TrainConfig())
    return path


def test_rd_ladder_resumes_and_matches_jax_bd_rate(checkpoint, tmp_path, monkeypatch):
    monkeypatch.setitem(rd_ladder.GRIDS, "coarse", (0.25, 1.0, 5.0, 10.0))
    monkeypatch.setattr(rd_ladder, "SyntheticKodak", SmallKodak)
    points = tmp_path / "points.jsonl"
    # two points already on disk, on the anchor's curve so the ranges overlap
    on_disk = [{"quality": 5.0, "bpp": 0.45, "psnr": 32.9}, {"quality": 10.0, "bpp": 0.69, "psnr": 35.4}]
    points.write_text("".join(json.dumps(dict(r, ms_ssim_db=12.0)) + "\n" for r in on_disk))
    args = ["--checkpoint", str(checkpoint), "--grid", "coarse", "--n-images", "1",
            "--out-jsonl", str(points), "--out", str(tmp_path / "rd.json"), "--lanes", "64",
            "--device", "cpu"]
    result = rd_ladder.main(args)
    assert result["coded_this_run"] == [0.25, 1.0]
    lines = [json.loads(s) for s in points.read_text().splitlines()]
    assert [r["quality"] for r in lines] == [5.0, 10.0, 0.25, 1.0]
    assert all({"enc_time", "dec_time", "wall_s", "n_images"} <= r.keys() for r in lines[2:])
    assert result["qualities"] == [0.25, 1.0, 5.0, 10.0]
    want = jax_rd.bd_rate(jax_rd.PROGRESSIVE_ANCHOR_BPP, jax_rd.PROGRESSIVE_ANCHOR_PSNR,
                          result["bpp"], result["psnr"])
    assert result["bd_rate_vs_fixed_pret"] == want
    assert json.loads((tmp_path / "rd.json").read_text()) == result
    assert rd_ladder.main(args)["coded_this_run"] == []


def test_rd_ladder_skips_a_line_cut_by_a_kill(tmp_path):
    path = tmp_path / "points.jsonl"
    path.write_text('{"quality": 1.0, "bpp": 0.3, "psnr": 30.0, "ms_ssim_db": 10.0}\n{"quality": 2.')
    assert [r["quality"] for r in rd_ladder.read_points(str(path))] == [1.0]
    assert rd_ladder.read_points(str(tmp_path / "none.jsonl")) == []


# ---------------------------------------------------------------------------
# bd_trajectory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", ["flagship_r3", "flagship_r3b", "flagship_r4", "flagship_r5"])
def test_bd_trajectory_matches_jax(run, tmp_path, capsys, monkeypatch):
    metrics = REPO / "runs" / run
    ours = bd_trajectory.main(["--run", str(metrics), "--out", str(tmp_path / "a.json")])
    ours_out = capsys.readouterr().out.replace("a.json", "out.json")
    jax_bdt = jax_tool("bd_trajectory")
    assert ours == jax_bdt.trajectory(str(metrics / "metrics.jsonl"))
    monkeypatch.setattr(sys, "argv", ["bd_trajectory.py", "--run", str(metrics),
                                      "--out", str(tmp_path / "b.json")])
    jax_bdt.main()
    assert capsys.readouterr().out.replace("b.json", "out.json") == ours_out
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_bd_trajectory_row_without_overlap(tmp_path):
    """A sweep whose PSNR range misses the anchor's: JAX's tool raises, the
    port's row says n/a and keeps the other columns."""
    sweep = {"epoch": 0, "test": {"bpp": [0.1, 0.2, 0.3, 0.4], "psnr": [10.0, 11.0, 12.0, 13.0]}}
    (tmp_path / "metrics.jsonl").write_text(json.dumps(sweep) + "\n")
    with pytest.raises(ValueError, match="do not overlap"):
        jax_tool("bd_trajectory").trajectory(str(tmp_path / "metrics.jsonl"))
    (row,) = bd_trajectory.trajectory(str(tmp_path / "metrics.jsonl"))
    assert row == {"epoch": 0, "bd_rate_pct_vs_anchor": "n/a (quality ranges do not overlap)",
                   "max_bpp": 0.4, "max_psnr": 13.0, "n_points": 4}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool, args", [
    ("profile_codec", []), ("bench_2k", []), ("rd_ladder", ["--checkpoint", "none"]),
    ("rem_demo", []), ("rem_flagship", ["--checkpoint", "none"]),
])
def test_tools_need_the_card_unless_asked(tool, args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"progressivecodec_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args)
