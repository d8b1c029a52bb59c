"""PyTorch port vs the JAX package: every lane count the JAX coder takes.

JAX's codec codes and decodes any K in [1, 65535] (the container's u16),
with K % G == 0 in PCT1-G.  The port's decode kernel runs a stream or group
of up to 1,024 lanes in one CTA and spans wider ones over several
(`rans_cuda.decode_span`); the plan that picks them is pure Python, so it is
checked here for every K.  Here on the CPU:

  * the port's encode gives streams byte-identical to JAX
    `rans_device.encode_stages` and to `rans_numpy`, and the port's decode
    (the plain twins the wrappers take on the CPU) returns exact values
    with stream_ok, at K in {16, 48, 100, 2048, 4100} and in PCT1-G at
    (K, G) = (4100, 4) and (4096, 2), escapes included;
  * the decode plan at every K from 1 to 65,535: CTAs, threads per CTA,
    cluster or grid, the stream ring and shared memory within the cap;
  * a TINY GranularCodec round trip at K = 16, 48, 2048 and (4100, G=4);
  * `tools.bench_coder --device cpu` at a tiny size.

The kernels at these lane counts run on the card in
tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.coder import rans_device as jrd
from progressivecodec_tpu.coder import rans_numpy
from progressivecodec_tpu.coder.tables import merge_tables as jax_merge_tables
from progressivecodec_tpu.entropy.bottleneck import build_bottleneck_tables as jax_bt
from progressivecodec_tpu.entropy.gaussian import build_gaussian_tables as jax_gt

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.tables import merge_tables
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck, build_bottleneck_tables
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables
from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
from progressivecodec_tpu_torch.models.weights import init_params
from progressivecodec_tpu_torch.tools import bench_coder

H100_CAP = 232_448
TINY = ModelConfig(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
                   scale_table=ScaleTableConfig(levels=32))


@pytest.fixture(scope="module")
def tables():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    hp = eb.host_params()
    scale = ScaleTableConfig(levels=32).values()
    ours, _ = merge_tables(build_bottleneck_tables(hp), build_gaussian_tables(scale))
    theirs, _ = jax_merge_tables(jax_bt(hp), jax_gt(scale))
    return ours, theirs, rans_device.DeviceTables.from_tables(ours, "cpu"), jrd.DeviceTables.from_tables(theirs)


def _stages(tables_np, seed, sizes=(5000, 2000)):
    """(symbols, indexes, keep) stages over every row, ~2% escapes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        idx = rng.integers(0, tables_np.cdf.shape[0], n).astype(np.int32)
        lo = tables_np.offset[idx]
        hi = lo + tables_np.max_symbol[idx]
        sym = np.floor(lo + rng.random(n) * (hi - lo + 1)).astype(np.int32)
        esc = rng.random(n) < 0.02
        sym[esc] = hi[esc] + rng.integers(1, 50, esc.sum())
        out.append((sym, idx, rng.random(n) < 0.85))
    return out


def _torch(stages):
    return [tuple(torch.from_numpy(a) for a in s) for s in stages]


@pytest.mark.parametrize("lanes", [16, 48, 100, 2048, 4100])
def test_single_stream_matches_jax_and_numpy_and_decodes(tables, lanes):
    ours_np, theirs_np, t, jt = tables
    stages = _stages(ours_np, lanes)
    streams, n_words, escs, n_esc = rans_device.encode_stages(_torch(stages), t, lanes)
    words = streams[0, : int(n_words)].numpy().view(np.uint16)
    esc_w = escs[0, : 2 * int(n_esc)].numpy().view(np.uint16)
    assert len(esc_w) > 0

    j_stream, j_nw, j_esc, j_ne = jrd.encode_stages([tuple(jnp.asarray(a) for a in s) for s in stages],
                                                    jt, lanes)
    np.testing.assert_array_equal(words, np.asarray(j_stream)[: int(j_nw)])
    np.testing.assert_array_equal(esc_w, np.asarray(j_esc)[: 2 * int(j_ne)])
    ref, esc_start = rans_numpy.encode_stages(stages, theirs_np, lanes)
    np.testing.assert_array_equal(words, ref[:esc_start])
    np.testing.assert_array_equal(esc_w, ref[esc_start:])

    streams = streams[:, : int(n_words)]
    escs = torch.nn.functional.pad(escs[:, : 2 * int(n_esc)], (0, 2))
    dec = rans_device.decoder_init(streams, lanes)
    for (sym, idx, keep), (_, ti, tk) in zip(stages, _torch(stages)):
        ig = rans_device._pad_to_grid(ti, lanes)
        kg = rans_device._pad_to_grid(tk.to(torch.uint8), lanes)
        states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
        esc_offsets, vals = rans_device.decode_stage_values(dec.esc_offsets, cums, escs, ti, tk, t, lanes)
        dec = rans_device.DecoderState(states, offsets, esc_offsets)
        np.testing.assert_array_equal(vals.numpy(), np.where(keep, sym, 0))
    assert bool(rans_device.stream_ok(dec))
    assert int(dec.offsets) == int(n_words) and int(dec.esc_offsets) == 2 * int(n_esc)


@pytest.mark.parametrize("lanes,groups", [(4100, 4), (4096, 2)])
def test_grouped_matches_jax_and_numpy_and_decodes(tables, lanes, groups):
    ours_np, theirs_np, t, jt = tables
    stages = _stages(ours_np, lanes + groups, sizes=(9000, 4200))
    streams, n_words, escs, n_escs = rans_device.encode_stages(_torch(stages), t, lanes, groups)
    ref = rans_numpy.encode_stages_grouped(stages, theirs_np, lanes, groups)
    for g in range(groups):
        words = streams[g, : int(n_words[g])].numpy().view(np.uint16)
        esc = escs[g, : 2 * int(n_escs[g])].numpy().view(np.uint16)
        np.testing.assert_array_equal(np.concatenate([words, esc]), ref[g][0], err_msg=f"group {g}")
    js, jnw, je, jne = jrd.encode_stages_grouped([tuple(jnp.asarray(a) for a in s) for s in stages],
                                                 jt, lanes, groups)
    np.testing.assert_array_equal(streams.numpy().view(np.uint16), np.asarray(js))
    np.testing.assert_array_equal(escs.numpy().view(np.uint16), np.asarray(je))
    np.testing.assert_array_equal(n_words.numpy(), np.asarray(jnw))

    escs = torch.nn.functional.pad(escs, (0, 2))
    dec = rans_device.decoder_init(streams, lanes)
    for (sym, _, keep), (_, ti, tk) in zip(stages, _torch(stages)):
        ig = rans_device._pad_to_grid(ti, lanes)
        kg = rans_device._pad_to_grid(tk.to(torch.uint8), lanes)
        states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
        esc_offs, vals = rans_device.decode_stage_values(dec.esc_offsets, cums, escs, ti, tk, t, lanes)
        dec = rans_device.DecoderState(states, offsets, esc_offs)
        np.testing.assert_array_equal(vals.numpy(), np.where(keep, sym, 0))
    assert bool(rans_device.stream_ok(dec))
    np.testing.assert_array_equal(dec.offsets.numpy(), n_words.numpy())


@pytest.mark.parametrize("first,last", [(1, 1024), (1025, 8192), (8193, 65536)])
def test_decode_span_covers_every_lane_count(first, last):
    """C CTAs of w threads hold the kt lanes, none empty: one CTA up to
    1,024 lanes, a cluster of 8 CTAs of kt / 8 lanes up to 8,192, above a
    grid of the fewest CTAs of at most 1,024 lanes (64 at most), evenly
    shared."""
    for kt in range(first, last + 1):
        c, w, grid = rans_cuda.decode_span(kt)
        assert w % 32 == 0 and 32 <= w <= 1024, kt
        assert (c - 1) * w < kt <= c * w, kt
        assert (c == 1) == (kt <= 1024) and grid == (c > 8) and c <= 64, kt
        assert grid == (kt > 8192), kt
        if c == 1:
            assert w == rans_cuda.warp_lanes(kt), kt
        else:
            assert w == rans_cuda.warp_lanes(-(-kt // (-(-kt // 1024) if grid else 8))), kt


def test_decode_span_refuses_what_no_launch_holds():
    """No lanes, or more than 64 CTAs of 1,024 hold."""
    for kt in (0, -1, 65537):
        with pytest.raises(ValueError, match="lanes per stream"):
            rans_cuda.decode_span(kt)


def test_plan_decode_at_every_lane_count():
    """The flagship's Gaussian rows at every K on an H100's budget: never
    more than 1,024 threads or the cap; one CTA keeps a ring that holds two
    refills of its lanes' words, and a stream that spans CTAs keeps none
    (its words are read from global memory)."""
    cfg = ModelConfig()
    eb = EntropyBottleneck(cfg.N, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    merged, starts = merge_tables(build_bottleneck_tables(eb.host_params()),
                                  build_gaussian_tables(cfg.scale_table.values()))
    compact = rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    rows = (starts[1], merged.cdf.shape[0])
    seen = set()
    for kt in range(1, 65536):
        p = rans_cuda.plan_decode(compact, rows, kt, H100_CAP)
        c, w, grid = rans_cuda.decode_span(kt)
        assert (p.ctas, p.cta_lanes, p.grid) == (c, w, grid)
        assert p.smem_bytes <= H100_CAP and p.cta_lanes <= 1024
        assert p.smem_bytes == rans_cuda.decode_smem_bytes(
            w, p.nrows, p.span_len, p.bucket_stride, p.ring_words, p.table_in_smem, c)
        if c == 1:
            need = 2 * rans_cuda.DECODE_REFILL * w + rans_cuda.STREAM_CHUNK
            assert p.ring_words >= need and p.ring_words & (p.ring_words - 1) == 0
        else:
            assert p.ring_words == 0
        seen.add(("grid" if p.grid else "cluster" if c > 1 else "one", p.table_in_smem))
    assert {("one", True), ("cluster", True), ("grid", True)} <= seen
    p = rans_cuda.plan_decode(compact, rows, 2048, H100_CAP)
    assert (p.ctas, p.cta_lanes, p.grid, p.ring_words, p.shift) == (8, 256, False, 0, 6)


@pytest.fixture(scope="module")
def model():
    m = ChannelProgressiveWACNN(TINY, device="cpu")
    m.load_state_dict(init_params(TINY, torch.Generator().manual_seed(0)), strict=True)
    return m


@pytest.mark.parametrize("lanes,groups", [(16, 1), (48, 1), (2048, 1), (4100, 4)])
def test_codec_round_trip_at_any_lane_count(model, lanes, groups):
    codec = GranularCodec(model, lanes=lanes, groups=groups, device="cpu")
    x = torch.from_numpy(np.random.default_rng(lanes).random((1, 64, 64, 3)).astype(np.float32))
    data = codec.compress(x, quality=5, simulate=True)
    back = codec.deserialize(codec.serialize(data))
    assert back["lanes"] == lanes
    out = codec.decompress(back)
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"])
    assert torch.equal(out["x_hat"], data["x_hat"])


def test_bench_coder_on_cpu(capsys):
    assert bench_coder.main(["--device", "cpu", "--n", "6000", "--stages", "3", "--lanes", "48,2048",
                             "--reps", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["lanes"] for r in lines] == [48, 2048]
    for r in lines:
        assert r["device"] == "cpu" and r["values_exact"] and r["stream_ok"] and r["n"] == 6000
        assert "enc_ms" not in r and r["host_dec_ms"] > 0
    assert lines[1]["plan"]["route"] == "cluster" and lines[1]["plan"]["ctas"] == 8
