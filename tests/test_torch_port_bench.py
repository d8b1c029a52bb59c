"""PyTorch port: the bench (`progressivecodec_tpu_torch/bench.py`), the port
of the root bench.py and tools/probe_honest.py.

At TINY (N=32, M=64, dim_chunk 8, division (32, 64)) on 64x64 images,
`--device cpu`, `--n 2`:
  * `main` runs the three (quality, batch) configurations, each in a
    process of its own (three distinct pids), and its last line carries
    every key of the root bench's last line plus the device; the probes
    checked every chain's stream_ok and the decoded y_hat;
  * the encode / decode / chain FLOP split against JAX's `count_flops` of
    the same fragments on the same weights: the convolutions and products
    equal, the port's transposed convolutions x s^2 equal JAX's
    lhs-dilated ones;
  * the MFU gate raises at an MFU of 1 or more;
  * a chain whose stream_ok is False ends the probe with an exception (a
    nonzero exit), and the orchestrator raises with the probe's tail;
  * the three processes built bit-identical weights from the seed, those
    of `seeded_model` here, and another seed gives other weights;
  * without a card and without `--device cpu` the bench raises.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess

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
from test_torch_port_profiling import split_jax_flops
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch import bench
from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.tools.profile_codec import seeded_model

TINY_KW = dict(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
CFG = ModelConfig(**TINY_KW, scale_table=ScaleTableConfig(levels=32))
JCFG = JaxModelConfig(**TINY_KW, scale_table=JaxScaleTableConfig(levels=32))
ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "q5_images_per_s",
             "per_image_stream_images_per_s", "pipelined_shallow_queue_images_per_s",
             "transform_gflops_per_image", "mfu", "peak_note", "baseline_note", "protocol_note",
             "device", "nvidia_smi")


def _args(tmp, *extra):
    cfg_path = tmp / "tiny.json"
    cfg_path.write_text(config_lib.to_json(CFG))
    return ["--device", "cpu", "--config", str(cfg_path), "--size", "64x64", "--n", "2",
            "--out-dir", str(tmp), *extra]


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """One run of the bench's `main` at TINY on the CPU: (its last line,
    the probes' records as written, the lines it printed)."""
    tmp = tmp_path_factory.mktemp("bench")
    # the probes are fresh interpreters: one torch thread each, as here
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = bench.main(_args(tmp))
    lines = out.getvalue().strip().splitlines()
    records = {f"q{q:g}_b{b}": json.loads(open(bench.record_path(str(tmp), q, b)).read())
               for q, b in bench.CONFIGS}
    return result, records, lines


def test_bench_runs_each_configuration_in_its_own_process(bench_run):
    result, records, lines = bench_run
    assert json.loads(lines[-1]) == result
    assert all(k in result for k in ROOT_KEYS), [k for k in ROOT_KEYS if k not in result]
    pids = {r["pid"] for r in records.values()}
    assert len(pids) == 3 and os.getpid() not in pids
    assert result["probes"] == records
    assert [(r["quality"], r["batch"]) for r in records.values()] == list(bench.CONFIGS)
    assert result["metric"] == "kodak_enc_dec_images_per_s_per_chip_q10"
    assert result["unit"] == "images/s" and result["device"] == "cpu"
    b8, b1, q5 = records["q10_b8"], records["q10_b1"], records["q5_b8"]
    assert result["value"] == max(b8["forced_sync_images_per_s"], b1["forced_sync_images_per_s"]) > 0
    assert result["vs_baseline"] == pytest.approx(result["value"] * 2.30)
    assert result["q5_images_per_s"] == q5["forced_sync_images_per_s"]
    assert result["per_image_stream_images_per_s"] == b1["forced_sync_images_per_s"]
    assert result["pipelined_shallow_queue_images_per_s"] == b8["images_per_s_scalar_fenced"]
    assert result["transform_gflops_per_image"] == sum(b8["flops"]["chain"].values()) / 1e9 > 0
    assert result["mfu"] == "not measured: no card" and "not measured" in result["nvidia_smi"]
    assert "flops" not in b1 and "flops" not in q5
    for name, r in records.items():
        assert r["stream_ok_all"] and r["y_hat_exact"] and r["x_hat_finite"], name
        assert r["device"] == "cpu" and r["n_chains"] == 2 and r["n_forced"] == 6, name
        assert r["bytes"] > 0 and r["bpp"] == 8 * r["bytes"] / (r["batch"] * 64 * 64), name
        assert (r["ms_per_image_median"] <= r["ms_per_image_p90"] <= r["ms_per_image_max"]), name
        assert r["forced_sync_images_per_s"] == pytest.approx(1e3 / r["ms_per_image_mean"]), name
        # on the CPU the scans run their plain twins, which count no launch
        assert r["launches_per_chain"] == {"encode": 0, "decode": 0, "grouped_decode": 0}, name


def test_same_seed_same_weights_in_every_process(bench_run):
    _, records, _ = bench_run
    digests = {r["weights_sha256"] for r in records.values()}
    assert len(digests) == 1
    assert digests == {bench.weights_digest(seeded_model(CFG, "cpu", 0))}
    assert bench.weights_digest(seeded_model(CFG, "cpu", 1)) not in digests


def test_flop_split_against_jax():
    sd = init_params(CFG, torch.Generator().manual_seed(0))
    params = import_progressive({k: v.numpy() for k, v in sd.items()}, JCFG)
    model = ChannelProgressiveWACNN(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    port = bench.chain_flops(model, 64, 64, "cpu")

    jmodel, v = JaxModel(cfg=JCFG), {"params": params}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    y = jnp.zeros((1, 4, 4, CFG.M), jnp.float32)
    y_hat = jnp.zeros((1, 4, 4, CFG.division_channel), jnp.float32)
    fragments = {
        "forward": (lambda v, xx: jmodel.apply(v, xx, 10.0, None, training=False,
                                               method=JaxModel.forward_single_quality), x),
        "analyze": (lambda v, xx: jmodel.apply(v, xx, method=JaxModel.analyze), x),
        "hyper_enc": (lambda v, yy: jmodel.apply(v, yy, method=JaxModel.codec_hyper_enc), y),
        "synth": (lambda v, yy: jmodel.apply(v, 1, yy, method=JaxModel.codec_synth), y_hat),
    }
    jax_parts = {}
    for name, (fn, arg) in fragments.items():
        dilated, transposed, other = split_jax_flops(jax.make_jaxpr(fn)(v, arg).jaxpr)
        assert dilated + other == jax_flops.count_flops(fn, v, arg), name
        jax_parts[name] = np.array([dilated, transposed, other])
        kinds = port[name]
        assert kinds["conv_transpose"] * 4 == dilated, name  # every deconvolution has stride 2
        assert kinds["conv"] + kinds["matmul"] == other, name
    f, a, h, s = (jax_parts[k] for k in ("forward", "analyze", "hyper_enc", "synth"))
    for name, want in (("encode", f - s), ("decode", f - a - h), ("chain", 2 * f - s - a - h)):
        got = port[name]
        assert got["conv_transpose"] == want[1] and got["conv_transpose"] * 4 == want[0], name
        assert got["conv"] + got["matmul"] == want[2], name
    assert port["chain"]["conv_transpose"] > 0 and port["encode"]["conv"] > 0


@pytest.mark.parametrize("mfu", [0.999, 1.0, 1.7])
def test_mfu_gate(mfu):
    peak, images_per_s = 66.9e12, 10.0
    flops = mfu * peak / images_per_s
    if mfu < 1.0:
        assert bench.gated_mfu(flops, images_per_s, peak) == pytest.approx(mfu)
        return
    with pytest.raises(AssertionError, match="IMPOSSIBLE MEASUREMENT"):
        bench.gated_mfu(flops, images_per_s, peak)


def test_a_broken_stream_fails_the_probe_and_the_bench(tmp_path, monkeypatch):
    decompress = GranularCodec.decompress

    def broken(self, data, *a, **kw):
        return {**decompress(self, data, *a, **kw), "stream_ok": False}

    monkeypatch.setattr(GranularCodec, "decompress", broken)
    with pytest.raises(RuntimeError, match="stream_ok is False"):
        bench.main(_args(tmp_path, "--probe", "--quality", "10", "--batch", "1"))

    def run_here(cmd, **kw):
        """The probe in this process, its exception as `python -m` exits."""
        assert cmd[1:4] == ["-m", "progressivecodec_tpu_torch.bench", "--probe"]
        try:
            bench.main(cmd[3:])
        except RuntimeError as e:
            return subprocess.CompletedProcess(cmd, 1, "", f"Traceback ...\nRuntimeError: {e}\n")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(bench.subprocess, "run", run_here)
    with pytest.raises(RuntimeError, match=r"probe q=10 b=8 failed rc=1(.|\n)*stream_ok is False"):
        bench.main(_args(tmp_path))
    assert not os.path.exists(bench.record_path(str(tmp_path), 10.0, 8))


@pytest.mark.parametrize("probe", [False, True])
def test_no_card_raises(tmp_path, monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--out-dir", str(tmp_path)] + (["--probe"] if probe else []))
