"""PyTorch port vs the JAX package: the PCT1 rANS coder, which is the
port's PCT1-G coder at one group.

The port's encode phases (the encode scan's plain twin on the CPU) must
produce streams byte-identical to JAX `rans_device.encode_stages`, to
`rans_numpy.encode_stages` and to the Pallas encode kernel run in interpret
mode, for the same (symbols, indexes, keep, tables, lanes).  The port must
decode the JAX streams to exact values with every lane state back at L.
The CUDA kernels are held to these twins in tests/test_torch_port_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from progressivecodec_tpu.coder import rans_device as jrd
from progressivecodec_tpu.coder import rans_numpy
from progressivecodec_tpu.coder.rans_pallas import encode_scan_rev_pallas
from progressivecodec_tpu.coder.tables import merge_tables as jax_merge_tables
from progressivecodec_tpu.entropy.bottleneck import build_bottleneck_tables as jax_bt
from progressivecodec_tpu.entropy.gaussian import build_gaussian_tables as jax_gt

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.tables import merge_tables
from progressivecodec_tpu_torch.config import ScaleTableConfig
from progressivecodec_tpu_torch.entropy.bottleneck import (
    EntropyBottleneck,
    build_bottleneck_tables,
)
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables

I32 = np.iinfo(np.int32)


@pytest.fixture(scope="module")
def tables():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    hp = eb.host_params()
    scale = ScaleTableConfig(levels=32).values()
    ours, starts = merge_tables(build_bottleneck_tables(hp), build_gaussian_tables(scale))
    theirs, jstarts = jax_merge_tables(jax_bt(hp), jax_gt(scale))
    assert starts == jstarts
    return ours, theirs, rans_device.DeviceTables.from_tables(ours, "cpu"), jrd.DeviceTables.from_tables(theirs)


def _stages(tables_np, seed, sizes, extreme=False):
    """Random (symbols, indexes, keep) stages over the merged rows; a few
    symbols fall outside their support (escapes), int32 extremes if asked."""
    rng = np.random.default_rng(seed)
    r = tables_np.cdf.shape[0]
    out = []
    for n in sizes:
        idx = rng.integers(0, r, n).astype(np.int32)
        lo = tables_np.offset[idx]
        hi = lo + tables_np.max_symbol[idx]
        sym = np.floor(lo + rng.random(n) * (hi - lo + 1)).astype(np.int32)
        esc = rng.random(n) < 0.02
        sym[esc] = hi[esc] + rng.integers(1, 50, esc.sum())
        if extreme:
            sym[:4] = [I32.min, I32.max, I32.min + 1, I32.max - 1]
        keep = rng.random(n) < 0.85
        out.append((sym, idx, keep))
    return out


def _port_encode(stages, t, lanes):
    st = [tuple(torch.from_numpy(a) for a in s) for s in stages]
    streams, n_words, escs, n_escs = rans_device.encode_stages(st, t, lanes)
    assert streams.shape[0] == escs.shape[0] == 1
    return (streams[0, : int(n_words)].numpy().view(np.uint16),
            escs[0, : 2 * int(n_escs)].numpy().view(np.uint16))


CASES = [(64, (37, 200, 64), False), (64, (1000,), True), (512, (700, 1537), True),
         (512, (5, 3000), False)]


@pytest.mark.parametrize("lanes,sizes,extreme", CASES)
def test_stream_byte_identical_to_jax_and_numpy(tables, lanes, sizes, extreme):
    ours_np, theirs_np, t, jt = tables
    stages = _stages(ours_np, lanes + sum(sizes), sizes, extreme)
    stream, esc = _port_encode(stages, t, lanes)

    jst = [tuple(jnp.asarray(a) for a in s) for s in stages]
    j_stream, j_nw, j_esc, j_ne = jrd.encode_stages(jst, jt, lanes)
    np.testing.assert_array_equal(stream, np.asarray(j_stream)[: int(j_nw)])
    np.testing.assert_array_equal(esc, np.asarray(j_esc)[: 2 * int(j_ne)])

    words, esc_start = rans_numpy.encode_stages(stages, theirs_np, lanes)
    np.testing.assert_array_equal(stream, words[:esc_start])
    np.testing.assert_array_equal(esc, words[esc_start:])
    if extreme:
        assert len(esc) > 0


@pytest.mark.parametrize("lanes,sizes,extreme", CASES[:3])
def test_stream_byte_identical_to_pallas_kernel(tables, lanes, sizes, extreme):
    ours_np, _, t, jt = tables
    stages = _stages(ours_np, 3 + lanes + sum(sizes), sizes, extreme)
    stream, esc = _port_encode(stages, t, lanes)
    jst = [tuple(jnp.asarray(a) for a in s) for s in stages]
    sf_rev, kp_rev, esc_flags, sym = jrd.encode_prepare(jst, jt, lanes)
    with pltpu.force_tpu_interpret_mode():
        states, words_rev, flags_rev = encode_scan_rev_pallas(sf_rev, kp_rev, lanes)
    p_stream, p_nw, p_esc, p_ne = jrd.encode_finalize(
        states, words_rev, flags_rev, esc_flags, sym, lanes
    )
    np.testing.assert_array_equal(stream, np.asarray(p_stream)[: int(p_nw)])
    np.testing.assert_array_equal(esc, np.asarray(p_esc)[: 2 * int(p_ne)])


@pytest.mark.parametrize("lanes,sizes,extreme", CASES)
def test_port_decodes_jax_stream_exactly(tables, lanes, sizes, extreme):
    ours_np, _, t, jt = tables
    stages = _stages(ours_np, 7 + lanes + sum(sizes), sizes, extreme)
    jst = [tuple(jnp.asarray(a) for a in s) for s in stages]
    j_stream, j_nw, j_esc, j_ne = jrd.encode_stages(jst, jt, lanes)
    streams = torch.from_numpy(np.asarray(j_stream)[: int(j_nw)].view(np.int16).copy())[None]
    escs = torch.from_numpy(np.concatenate([np.asarray(j_esc)[: 2 * int(j_ne)],
                                            np.zeros(2, np.uint16)]).view(np.int16))[None]
    dec = rans_device.decoder_init(streams, lanes)
    for sym, idx, keep in stages:
        ig = rans_device._pad_to_grid(torch.from_numpy(idx), lanes)
        kg = rans_device._pad_to_grid(torch.from_numpy(keep).to(torch.uint8), lanes)
        states, offsets, cums = rans_device.decode_stage_scan(dec, streams, ig, kg, t, lanes)
        esc_offsets, vals = rans_device.decode_stage_values(
            dec.esc_offsets, cums, escs, torch.from_numpy(idx), torch.from_numpy(keep), t, lanes
        )
        dec = rans_device.DecoderState(states, offsets, esc_offsets)
        np.testing.assert_array_equal(vals.numpy(), np.where(keep, sym, 0))
    assert bool(rans_device.stream_ok(dec))
    assert int(dec.offsets) == int(j_nw)
    assert int(dec.esc_offsets) == 2 * int(j_ne)


# ---------------------------------------------------------------------------
# the scans' plain twins against the JAX scans
# ---------------------------------------------------------------------------


def _random_sf(p, k, seed, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        freq = np.where(rng.random((p, k)) < 0.5, 1, 65535).astype(np.uint32)
        start = np.zeros((p, k), np.uint32)
        kp = np.ones((p, k), bool)
    else:
        freq = rng.integers(1, 60000, (p, k)).astype(np.uint32)
        start = rng.integers(0, 65536 - freq, (p, k)).astype(np.uint32)
        kp = rng.random((p, k)) < 0.8
    return (start << 16) | freq, kp


@pytest.mark.parametrize("p,k,seed,extreme", [(37, 64, 0, False), (8, 8, 1, False),
                                              (300, 128, 2, False), (16, 64, 3, True)])
def test_encode_scan_twin_bit_identical_to_jax(p, k, seed, extreme):
    sf, kp = _random_sf(p, k, seed, extreme)
    js, jw, jf = jrd.encode_scan_rev(jnp.asarray(sf), jnp.asarray(kp), k)
    ts, tw, tf = rans_cuda.rans_encode_scan(
        torch.from_numpy(sf.view(np.int32)), torch.from_numpy(kp.astype(np.uint8))
    )
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js))
    np.testing.assert_array_equal(tw.numpy().view(np.uint16), np.asarray(jw))
    np.testing.assert_array_equal(tf.numpy().astype(bool), np.asarray(jf))


@pytest.mark.parametrize("lanes,n", [(64, 900), (512, 2049)])
def test_decode_scan_twin_bit_identical_to_jax(tables, lanes, n):
    ours_np, _, t, jt = tables
    (sym, idx, keep), = _stages(ours_np, n, (n,))
    j_stream, j_nw, _, _ = jrd.encode_stages([(jnp.asarray(sym), jnp.asarray(idx), jnp.asarray(keep))], jt, lanes)
    j_stream = np.asarray(j_stream)[: int(j_nw)]
    jdec = jrd.decoder_init(jnp.asarray(j_stream), lanes)
    ig = jrd._pad_to_grid(jnp.asarray(idx), lanes)
    kg = jrd._pad_to_grid(jnp.asarray(keep), lanes)
    js, jo, jc = jrd.decode_stage_scan(jdec, jnp.asarray(j_stream), ig, kg, jt, lanes)
    streams = torch.from_numpy(j_stream.view(np.int16).copy())[None]
    dec = rans_device.decoder_init(streams, lanes)
    ts, to, tc = rans_cuda.rans_decode_scan(
        dec.states, dec.offsets, streams, torch.from_numpy(np.array(ig)),
        torch.from_numpy(np.asarray(kg).astype(np.uint8)), t.dec_sf,
    )
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js))
    assert int(to) == int(jo)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))
