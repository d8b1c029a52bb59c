"""PyTorch port vs the JAX package: the PCT1-G grouped coder.

  * the port's `encode_stages` at G groups (encode scan twin on the CPU,
    per-group compaction) gives sub-streams byte-identical to JAX
    `rans_device.encode_stages_grouped` and to `rans_numpy.encode_stages_grouped`,
    escapes included;
  * the decode phases decode them to exact values with stream_ok, and their
    states, offsets and values equal JAX `decode_stage_grouped`'s;
  * per group, the coder's path at G groups is its path at one group on
    that group's column block;
  * lane and group checks.  The CUDA kernel is held to the twin in
    tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivecodec_tpu.coder import rans_device as jrd
from progressivecodec_tpu.coder import rans_numpy
from progressivecodec_tpu.coder.tables import merge_tables as jax_merge_tables
from progressivecodec_tpu.entropy.gaussian import build_gaussian_tables as jax_gt

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.tables import check_groups, check_lanes, merge_tables
from progressivecodec_tpu_torch.config import ScaleTableConfig
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables
from progressivecodec_tpu_torch.utils import profiling

LANES_GROUPS = [(64, 4), (32, 4), (64, 64)]


@pytest.fixture(scope="module")
def tables():
    scale = ScaleTableConfig(levels=32).values()
    ours, _ = merge_tables(build_gaussian_tables(scale))
    theirs, _ = jax_merge_tables(jax_gt(scale))
    return ours, theirs, rans_device.DeviceTables.from_tables(ours, "cpu"), jrd.DeviceTables.from_tables(theirs)


def _stages(tables_np, seed, sizes=((700, 0.8), (130, 1.0))):
    """(symbols, indexes, keep) stages with ~2% escapes of up to 1e6."""
    rng = np.random.default_rng(seed)
    out = []
    for n, keep_p in sizes:
        idx = rng.integers(0, tables_np.cdf.shape[0], n).astype(np.int32)
        sym = np.round(rng.standard_normal(n) * 4).astype(np.int32)
        hot = rng.random(n) < 0.02
        sym = np.where(hot, (rng.standard_normal(n) * 1e6).astype(np.int32), sym)
        out.append((sym, idx, rng.random(n) < keep_p))
    return out


def _port_encode(stages, t, lanes, groups):
    return rans_device.encode_stages(
        [tuple(torch.from_numpy(a) for a in s) for s in stages], t, lanes, groups
    )


@pytest.mark.parametrize("lanes,groups", LANES_GROUPS)
def test_grouped_streams_byte_identical_to_jax_and_numpy(tables, lanes, groups):
    ours_np, theirs_np, t, jt = tables
    stages = _stages(ours_np, lanes + groups)
    streams, n_words, escs, n_escs = _port_encode(stages, t, lanes, groups)
    assert int(n_escs.sum()) > 0
    ref = rans_numpy.encode_stages_grouped(stages, theirs_np, lanes, groups)
    for g in range(groups):
        words = streams[g, : int(n_words[g])].numpy().view(np.uint16)
        esc = escs[g, : 2 * int(n_escs[g])].numpy().view(np.uint16)
        assert int(n_words[g]) == ref[g][1], f"group {g}"
        np.testing.assert_array_equal(np.concatenate([words, esc]), ref[g][0], err_msg=f"group {g}")
    jst = [tuple(jnp.asarray(a) for a in s) for s in stages]
    js, jnw, je, jne = jrd.encode_stages_grouped(jst, jt, lanes, groups)
    np.testing.assert_array_equal(streams.numpy().view(np.uint16), np.asarray(js))
    np.testing.assert_array_equal(escs.numpy().view(np.uint16), np.asarray(je))
    np.testing.assert_array_equal(n_words.numpy(), np.asarray(jnw))
    np.testing.assert_array_equal(n_escs.numpy(), np.asarray(jne))


@pytest.mark.parametrize("lanes,groups", LANES_GROUPS)
def test_grouped_twin_decodes_exactly_and_matches_jax(tables, lanes, groups):
    ours_np, _, t, jt = tables
    stages = _stages(ours_np, 100 + lanes + groups)
    streams, n_words, escs, n_escs = _port_encode(stages, t, lanes, groups)
    escs = torch.nn.functional.pad(escs, (0, 2))
    dec = rans_device.decoder_init(streams, lanes)
    js = jnp.asarray(streams.numpy().view(np.uint16))
    je = jnp.asarray(escs.numpy().view(np.uint16))
    jdec = jrd.grouped_decoder_init(js, lanes, groups)
    for sym, idx, keep in stages:
        ig = rans_device._pad_to_grid(torch.from_numpy(idx), lanes)
        kg = rans_device._pad_to_grid(torch.from_numpy(keep).to(torch.uint8), lanes)
        states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
        esc_offsets, vals = rans_device.decode_stage_values(
            dec.esc_offsets, cums, escs, torch.from_numpy(idx), torch.from_numpy(keep), t, lanes
        )
        dec = rans_device.DecoderState(states, offsets, esc_offsets)
        np.testing.assert_array_equal(vals.numpy(), np.where(keep, sym, 0))
        jdec, jvals = jrd.decode_stage_grouped(jdec, js, je, jnp.asarray(idx), jnp.asarray(keep),
                                               jt, lanes, groups)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(states.numpy().view(np.uint32), np.asarray(jdec.states))
        np.testing.assert_array_equal(offsets.numpy(), np.asarray(jdec.offsets))
        np.testing.assert_array_equal(esc_offsets.numpy(), np.asarray(jdec.esc_offsets))
    assert bool(rans_device.stream_ok(dec))
    np.testing.assert_array_equal(dec.offsets.numpy(), n_words.numpy())
    np.testing.assert_array_equal(dec.esc_offsets.numpy(), 2 * n_escs.numpy())


@pytest.mark.parametrize("lanes,groups", [(64, 4), (96, 3), (64, 64)])
def test_grouped_twin_is_the_single_twin_per_group(tables, lanes, groups):
    """Group g's decode at G groups is the coder's decode at one group of
    its own kt lanes from its own sub-stream: states, offsets, cums,
    values and escape offsets."""
    ours_np, _, t, _ = tables
    (stage,) = _stages(ours_np, 7 * lanes + groups, ((900, 0.9),))
    streams, _, escs, _ = _port_encode([stage], t, lanes, groups)
    escs = torch.nn.functional.pad(escs, (0, 2))
    dec = rans_device.decoder_init(streams, lanes)
    ig = rans_device._pad_to_grid(torch.from_numpy(stage[1]), lanes)
    kg = rans_device._pad_to_grid(torch.from_numpy(stage[2]).to(torch.uint8), lanes)
    states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
    esc_offsets, vals = rans_device.decode_stage_values(
        dec.esc_offsets, cums, escs, ig.reshape(-1), kg.reshape(-1), t, lanes)
    vals = vals.reshape(ig.shape)
    kt = lanes // groups
    for g in range(groups):
        cols = slice(g * kt, (g + 1) * kt)
        one = rans_device.decoder_init(streams[g : g + 1], kt)
        assert torch.equal(one.states, dec.states[cols])
        ig_g, kg_g = ig[:, cols].contiguous(), kg[:, cols].contiguous()
        s, o, c = rans_device.decode_stage_scan(one, streams[g : g + 1], ig_g, kg_g, t, kt)
        assert torch.equal(s, states[cols]) and int(o) == int(offsets[g])
        assert torch.equal(c, cums[:, cols])
        e, v = rans_device.decode_stage_values(
            one.esc_offsets, c, escs[g : g + 1], ig_g.reshape(-1), kg_g.reshape(-1), t, kt)
        assert int(e) == int(esc_offsets[g]) and torch.equal(v, vals[:, cols].reshape(-1))


def test_grouped_wrapper_takes_the_twin_on_cpu_and_counts_no_launch(tables):
    ours_np, _, t, _ = tables
    streams, _, _, _ = _port_encode(_stages(ours_np, 3), t, 64, 4)
    dec = rans_device.decoder_init(streams, 64)
    ig = torch.zeros((3, 64), dtype=torch.int32)
    kg = torch.ones((3, 64), dtype=torch.uint8)
    before = profiling.total("launch:rans_decode_scan")
    got = rans_cuda.rans_decode_scan(dec.states, dec.offsets, streams, ig, kg, t.dec_sf)
    want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offsets, streams, ig, kg, t.dec_sf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.total("launch:rans_decode_scan") == before


@pytest.mark.parametrize("bad", ["offsets", "lanes_not_multiple", "streams_dtype"])
def test_grouped_wrapper_rejects_bad_inputs(bad):
    k, g = 64, 4
    args = dict(states=torch.zeros(k, dtype=torch.int32), offsets=torch.zeros(g, dtype=torch.int32),
                streams=torch.zeros((g, 16), dtype=torch.int16), idx=torch.zeros((2, k), dtype=torch.int32),
                kp=torch.zeros((2, k), dtype=torch.uint8), dec_sf=torch.zeros(1 << 16, dtype=torch.int32))
    if bad == "offsets":
        args["offsets"] = torch.zeros(g + 1, dtype=torch.int32)
    elif bad == "lanes_not_multiple":
        args["streams"] = torch.zeros((3, 16), dtype=torch.int16)
        args["offsets"] = torch.zeros(3, dtype=torch.int32)
    else:
        args["streams"] = args["streams"].to(torch.int32)
    with pytest.raises(ValueError):
        rans_cuda.rans_decode_scan(**args)


def test_encode_scan_pads_a_lane_count_off_the_warp(tables):
    """K = 96 lanes, 3 groups of 32: the encode scan runs padded to whole
    warps and gives the unpadded scan's words."""
    ours_np, _, t, _ = tables
    st = [tuple(torch.from_numpy(a) for a in s) for s in _stages(ours_np, 5)]
    sf_rev, kp_rev, _, _ = rans_device.encode_prepare(st, t, 96)
    got = rans_device.encode_scan_rev(sf_rev, kp_rev, 96)
    want = rans_cuda.rans_encode_scan_plain(sf_rev, kp_rev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("lanes,groups,ok", [(64, 4, True), (32, 4, True), (64, 64, True), (96, 3, True),
                                             (4096, 4, True), (48, 1, True), (66, 4, False),
                                             (4100, 4, True), (2 ** 16, 256, False), (8, 0, False),
                                             (0, 1, False), (2 ** 16, 1, False)])
def test_grouped_lane_checks(lanes, groups, ok):
    """A lane count is what JAX's codec takes: an integer in [1, 65535] (the
    container's u16), with groups > 1 a multiple of groups, however wide a
    group; groups lie in [1, 255] (the container's u8)."""
    if ok:
        assert check_lanes(lanes, check_groups(groups)) == lanes
    else:
        with pytest.raises(ValueError):
            check_lanes(lanes, check_groups(groups))
