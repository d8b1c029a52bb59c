"""The port's CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Tests marked `cuda` need an NVIDIA card (the kernels have no CPU mode) and
skip without one; they decide that inside a fixture.  The other tests check
the wrappers' routing and input checks on the CPU.
"""

import numpy as np
import pytest
import torch

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.tables import merge_tables
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig
from progressivecodec_tpu_torch.entropy.bottleneck import EntropyBottleneck, build_bottleneck_tables
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables
from progressivecodec_tpu_torch.utils import profiling

TINY = ModelConfig(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
                   scale_table=ScaleTableConfig(levels=32))


@pytest.fixture(scope="module")
def tables():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    merged, _ = merge_tables(build_bottleneck_tables(eb.host_params()),
                             build_gaussian_tables(ScaleTableConfig(levels=32).values()))
    return merged, rans_device.DeviceTables.from_tables(merged, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_sf(p, k, seed, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        freq = np.where(rng.random((p, k)) < 0.5, 1, 65535).astype(np.uint32)
        return freq, np.ones((p, k), bool)
    freq = rng.integers(1, 65536, (p, k)).astype(np.uint32)
    start = rng.integers(0, 65536 - freq).astype(np.uint32)
    return (start << 16) | freq, rng.random((p, k)) < 0.8


def _stage(tables_np, n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, tables_np.cdf.shape[0], n).astype(np.int32)
    lo = tables_np.offset[idx].astype(np.int64)
    hi = lo + tables_np.max_symbol[idx]
    sym = np.floor(lo + rng.random(n) * (hi - lo + 1)).astype(np.int64)
    esc = rng.random(n) < 0.02
    sym[esc] = hi[esc] + 7
    return sym.astype(np.int32), idx, rng.random(n) < 0.85


def _as_tensors(sf, kp, device="cpu"):
    return (torch.from_numpy(sf.view(np.int32)).to(device),
            torch.from_numpy(kp.astype(np.uint8)).to(device))


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch(tables):
    scans = ("launch:rans_encode_scan", "launch:rans_decode_scan")
    before = [profiling.total(n) for n in scans]
    sf, kp = _as_tensors(*_random_sf(5, 32, 9))
    assert all(torch.equal(a, b) for a, b in zip(rans_cuda.rans_encode_scan(sf, kp),
                                                 rans_cuda.rans_encode_scan_plain(sf, kp)))
    _, t = tables
    st = [tuple(torch.from_numpy(a) for a in _stage(tables[0], 300, 1))]
    stream, n_words, _, _ = rans_device.encode_stages(st, t, 64)
    dec = rans_device.decoder_init(stream[: int(n_words)], 64)
    ig = rans_device._pad_to_grid(st[0][1], 64)
    kg = rans_device._pad_to_grid(st[0][2].to(torch.uint8), 64)
    rans_cuda.rans_decode_scan(dec.states, dec.offset, stream, ig, kg, t.dec_sf)
    assert [profiling.total(n) for n in scans] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_encode_scan_wrapper_rejects_bad_inputs(bad):
    sf = torch.zeros((4, 32), dtype=torch.int32)
    kp = torch.ones((4, 32), dtype=torch.uint8)
    if bad == "dtype":
        sf = sf.to(torch.int64)
    elif bad == "shape":
        kp = kp[:3]
    elif bad == "contiguity":
        sf = torch.zeros((32, 4), dtype=torch.int32).t()
    else:
        kp = kp.to("meta")
    with pytest.raises(ValueError):
        rans_cuda.rans_encode_scan(sf, kp)


@pytest.mark.parametrize("bad", ["stream_dtype", "offset_shape", "lanes"])
def test_decode_scan_wrapper_rejects_bad_inputs(bad):
    k = 64
    args = dict(states=torch.zeros(k, dtype=torch.int32), offset=torch.zeros(1, dtype=torch.int32),
                stream=torch.zeros(10, dtype=torch.int16), idx=torch.zeros((2, k), dtype=torch.int32),
                kp=torch.zeros((2, k), dtype=torch.uint8), dec_sf=torch.zeros(1 << 16, dtype=torch.int32))
    if bad == "stream_dtype":
        args["stream"] = args["stream"].to(torch.int32)
    elif bad == "offset_shape":
        args["offset"] = torch.zeros(2, dtype=torch.int32)
    else:
        args["states"] = torch.zeros(k + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        rans_cuda.rans_decode_scan(**args)


def test_int_bit_pattern_helpers_round_trip():
    u = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    i32 = rans_cuda.to_i32(u)
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(i32.numpy().view(np.uint32), u.numpy().astype(np.uint32))
    assert torch.equal(rans_cuda.u32(i32), u)
    w = torch.tensor([0, 0x7FFF, 0x8000, 0xFFFF, 0x1ABCD], dtype=torch.int64)
    np.testing.assert_array_equal(rans_cuda.to_i16(w).numpy().view(np.uint16),
                                  (w.numpy() & 0xFFFF).astype(np.uint16))


@pytest.mark.parametrize("groups", range(1, 18))
def test_decode_cluster_is_the_largest_divisor_up_to_eight(groups):
    c = rans_cuda.decode_cluster(groups)
    assert groups % c == 0 and 1 <= c <= rans_cuda.MAX_CLUSTER == 8
    assert not any(groups % d == 0 for d in range(c + 1, min(groups, 8) + 1))


@pytest.mark.parametrize("table_in_smem", [True, False])
def test_decode_smem_bytes_counts_the_table_barrier(table_in_smem):
    """The kernel's layout: 64 bytes of warp counts, the table (rows' bases,
    starts, buckets, each padded to 16 bytes), the idx / keep ring, the
    stream ring and the table's mbarrier in a 16-byte slot."""
    lanes, nrows, span, stride, ring = 128, 3, 40, 24, 2048
    table = (16 + 80 + 3 * 24 * 2) if table_in_smem else 0
    assert rans_cuda.decode_smem_bytes(lanes, nrows, span, stride, ring, table_in_smem) == (
        64 + table + rans_cuda.DECODE_SLOTS * lanes * 5 + 2 * ring + 16)


@pytest.mark.parametrize("lanes,groups", [(64, 8), (48, 16), (88, 11), (96, 6)])
def test_grouped_wrapper_on_cpu_takes_the_twin_at_cluster_shapes(tables, lanes, groups):
    """Whatever cluster a CUDA launch would take, CPU tensors go to the twin
    and count no launch."""
    merged, t = tables
    st = [tuple(torch.from_numpy(a) for a in _stage(merged, 400, groups))]
    streams, _, _, _ = rans_device.encode_stages_grouped(st, t, lanes, groups)
    dec = rans_device.grouped_decoder_init(streams, lanes, groups)
    ig = rans_device._pad_to_grid(st[0][1], lanes)
    kg = rans_device._pad_to_grid(st[0][2].to(torch.uint8), lanes)
    before = profiling.total("launch:rans_decode_scan_grouped")
    got = rans_cuda.rans_decode_scan_grouped(dec.states, dec.offsets, streams, ig, kg, t.dec_sf)
    want = rans_cuda.rans_decode_scan_grouped_plain(dec.states, dec.offsets, streams, ig, kg, t.dec_sf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.total("launch:rans_decode_scan_grouped") == before


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in numpy
# ---------------------------------------------------------------------------


def _emulated_lookup(compact, row, shift):
    """The decode kernel's symbol search for every cum of one CDF row: a
    bucket pair then a 4-ary search (shift None: the global-table path,
    the same search over the whole row).  Returns (start, freq)."""
    base, n = (int(v) for v in compact.meta[row])
    st = compact.starts.numpy().view(np.uint16).astype(np.int64)[base : base + n + 1]
    cum = np.arange(1 << 16, dtype=np.int64)
    if shift is None:
        lo, hi = np.zeros_like(cum), np.full_like(cum, n - 1)
    else:
        entry = compact.bucket_rows((row, row + 1), shift)[0].astype(np.int64)
        bucket, flag = entry & (rans_cuda.RUN_FLAG - 1), entry & rans_cuda.RUN_FLAG
        lo, hi = bucket[cum >> shift], bucket[(cum >> shift) + 1]
        run = flag[cum >> shift] != 0
        hi = np.where(run, lo, hi)
    while (lo < hi).any():  # the kernel's 4-ary search
        act, w = lo < hi, hi - lo
        m1, m2, m3 = lo + (w + 3) // 4, lo + (2 * w + 3) // 4, lo + (3 * w + 3) // 4
        b1, b2, b3 = (st[np.where(act, m, 0)] <= cum for m in (m1, m2, m3))
        new_hi = np.where(b3, hi, np.where(b2, m3 - 1, np.where(b1, m2 - 1, m1 - 1)))
        new_lo = np.where(b3, m3, np.where(b2, m2, np.where(b1, m1, lo)))
        lo, hi = np.where(act, new_lo, lo), np.where(act, new_hi, hi)
    nxt = ((st[lo + 1] - 1) & 0xFFFF) + 1
    if shift is None:
        return st[lo], nxt - st[lo]
    return np.where(run, cum, st[lo]), np.where(run, 1, nxt - st[lo])


@pytest.mark.parametrize("which,shifts", [("tiny", (6, 7, 8, 12, 16, None)),
                                          ("flagship_gaussian", (6, None))])
def test_compact_table_lookup_equals_dec_sf(tables, which, shifts):
    """For every (row, cum): the kernel's lookup in the compact table gives
    the (start, freq) of dec_sf, the twin's table.  The flagship's 64
    Gaussian rows at the shift and the path the codec uses, the TINY tables
    at every shift."""
    if which == "tiny":
        merged, t = tables
    else:
        merged, _ = merge_tables(build_gaussian_tables(ModelConfig().scale_table.values()))
        t = rans_device.DeviceTables.from_tables(merged, "cpu")
    compact = rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    dec_sf = t.dec_sf.numpy().view(np.uint32).reshape(-1, 1 << 16).astype(np.int64)
    for row in range(dec_sf.shape[0]):
        for shift in shifts:
            start, freq = _emulated_lookup(compact, row, shift)
            np.testing.assert_array_equal(start, dec_sf[row] >> 16, err_msg=f"row {row} shift {shift}")
            np.testing.assert_array_equal(freq, dec_sf[row] & 0xFFFF, err_msg=f"row {row} shift {shift}")


def test_encode_reciprocal_division_is_exact_for_every_freq():
    """The encode kernel's division: q' = trunc(float32(y) * r) with r any
    float32 within 1 ulp of 1/freq (rcp.approx: the correctly rounded value
    or either neighbour), corrected by one test of y - q'*freq, equals
    y // freq, and its state update equals the twin's, for every freq in
    [1, 65535] at boundary and random y < freq << 16."""
    freq = np.arange(1, 1 << 16, dtype=np.uint64)[:, None]
    top = freq << np.uint64(16)
    rng = np.random.default_rng(0)
    y = np.concatenate([
        np.zeros_like(freq), np.ones_like(freq), freq - 1, freq, freq + 1, 2 * freq - 1,
        top // 2, top - freq - 1, top - freq, top - 1,
        (rng.random((freq.shape[0], 16)) * top.astype(np.float64)).astype(np.uint64),
    ], axis=1)
    y = np.minimum(y, top - 1)
    start = rng.integers(0, 1 << 16, y.shape).astype(np.uint64) % (np.uint64(65537) - freq)
    rcp_rn = np.float32(1.0) / freq.astype(np.float32)
    for rcp in (rcp_rn, np.nextafter(rcp_rn, np.float32(0)), np.nextafter(rcp_rn, np.float32(2))):
        q0 = (y.astype(np.float64).astype(np.float32) * rcp).astype(np.uint64)
        r0 = y.astype(np.int64) - (q0 * freq).astype(np.int64)
        q = q0 - (r0 < 0) + (r0 >= freq.astype(np.int64))
        np.testing.assert_array_equal(q, y // freq)
        np.testing.assert_array_equal(y + start + q * (np.uint64(65536) - freq),
                                      ((y // freq) << np.uint64(16)) + y % freq + start)


def test_plan_decode_keeps_the_flagship_stages_on_chip():
    """At K=512 on an H100's 232,448-byte budget the Gaussian rows take the
    finest buckets and the bottleneck rows fit; K=1024 still fits."""
    cfg = ModelConfig()
    eb = EntropyBottleneck(cfg.N, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    merged, starts = merge_tables(build_bottleneck_tables(eb.host_params()),
                                  build_gaussian_tables(cfg.scale_table.values()))
    compact = rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    r, row0 = merged.cdf.shape[0], starts[1]
    for lanes, rows, shift in [(512, (row0, r), 6), (512, (0, row0), 8), (1024, (row0, r), 7)]:
        plan = rans_cuda.plan_decode(compact, rows, lanes, 232_448)
        assert plan.table_in_smem and plan.shift == shift and plan.smem_bytes <= 232_448


def test_compact_cdf_keeps_one_bucket_table_per_row_range(tables):
    """CPU tables carry no CompactCdf (the twin reads dec_sf).  A CompactCdf
    builds the bucket table of a (row range, shift) once, on first use, and
    keeps each launch plan."""
    merged, t = tables
    assert t.compact is None
    compact = rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    r = merged.cdf.shape[0]
    plan = rans_cuda.plan_decode(compact, (1, r), 64, 232_448)
    assert rans_cuda.plan_decode(compact, [1, r], 64, 232_448) is plan
    table = compact.buckets((1, r), plan.shift)
    assert compact.buckets([1, r], plan.shift) is table
    assert table.dtype == torch.int16 and table.numel() == (r - 1) * plan.bucket_stride
    np.testing.assert_array_equal(table.numpy().view(np.uint16).reshape(r - 1, -1)[2],
                                  compact.bucket_rows((3, 4), plan.shift)[0])


@pytest.mark.parametrize("which", ["empty", "reversed", "past_the_end"])
def test_plan_decode_refuses_row_ranges_outside_the_table(tables, which):
    merged, _ = tables
    compact = rans_cuda.CompactCdf(merged.cdf, merged.cdf_length, "cpu")
    r = merged.cdf.shape[0]
    rows = {"empty": (2, 2), "reversed": (3, 2), "past_the_end": (0, r + 1)}[which]
    with pytest.raises(ValueError, match="outside"):
        rans_cuda.plan_decode(compact, rows, 64, 232_448)
    assert not compact.plans


# ---------------------------------------------------------------------------
# card-only: kernels against their plain twins, and the codec on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("p,k,extreme", [(1, 32, False), (37, 64, False), (300, 512, False),
                                         (16, 64, True), (1956, 512, False), (100, 224, False),
                                         (0, 64, False), (33, 1024, True)])
def test_encode_kernel_matches_twin(cuda_device, p, k, extreme):
    sf, kp = _as_tensors(*_random_sf(p, k, p + k, extreme), cuda_device)
    n0 = profiling.total("launch:rans_encode_scan")
    got = rans_cuda.rans_encode_scan(sf, kp)
    torch.cuda.synchronize()
    assert profiling.total("launch:rans_encode_scan") == n0 + 1
    want = rans_cuda.rans_encode_scan_plain(sf, kp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_encode_kernel_rejects_lanes_it_cannot_run(cuda_device):
    sf, kp = _as_tensors(*_random_sf(4, 200, 0), cuda_device)
    with pytest.raises(ValueError, match="lanes"):
        rans_cuda.rans_encode_scan(sf, kp)


def _decode_on_card(tables_np, device, lanes, n, seed, rows=None, smem_cap=None, stage=None):
    """Code one stage on the CPU, decode it with the kernel and the twin."""
    t = rans_device.DeviceTables.from_tables(tables_np, "cpu")
    st = [stage or tuple(torch.from_numpy(a) for a in _stage(tables_np, n, seed))]
    stream, n_words, _, _ = rans_device.encode_stages(st, t, lanes)
    stream = stream[: int(n_words)].to(device)
    dec = rans_device.decoder_init(stream, lanes)
    ig = rans_device._pad_to_grid(st[0][1], lanes).to(device)
    kg = rans_device._pad_to_grid(st[0][2].to(torch.uint8), lanes).to(device)
    td = rans_device.DeviceTables.from_tables(tables_np, device)
    n0 = profiling.total("launch:rans_decode_scan")
    got = rans_cuda.rans_decode_scan(dec.states, dec.offset, stream, ig, kg, td.dec_sf, td.compact,
                                     rows, smem_cap=smem_cap)
    torch.cuda.synchronize()
    assert profiling.total("launch:rans_decode_scan") == n0 + 1
    want = rans_cuda.rans_decode_scan_plain(dec.states, dec.offset, stream, ig, kg, td.dec_sf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if n:
        assert bool(rans_device.stream_ok(rans_device.DecoderState(got[0], got[1], dec.esc_offset)))
        assert int(got[1]) == int(n_words)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n", [(32, 100), (64, 900), (512, 20000), (1024, 5000),
                                     (64, 0), (64, 64)])
def test_decode_kernel_matches_twin(cuda_device, tables, lanes, n):
    _decode_on_card(tables[0], cuda_device, lanes, n, n + lanes)


def _smem_cap(tables_np, lanes, path):
    """A shared-memory cap that selects `path`: the finest buckets that fit
    the card ("default"), 64-cum buckets' worth less ("coarse"), or only the
    rings ("global")."""
    compact = rans_cuda.CompactCdf(tables_np.cdf, tables_np.cdf_length, "cpu")
    full = rans_cuda.plan_decode(compact, (0, tables_np.cdf.shape[0]), lanes, 1 << 30)
    if path == "default":
        return None
    if path == "coarse":
        return rans_cuda.decode_smem_bytes(lanes, full.nrows, full.span_len, 24, full.ring_words, True)
    return rans_cuda.decode_smem_bytes(lanes, full.nrows, full.span_len, 0, full.ring_words, False)


@pytest.mark.parametrize("path,shift", [("coarse", 12), ("global", 16)])
def test_plan_decode_picks_the_path_the_cap_allows(tables, path, shift):
    tables_np = tables[0]
    compact = rans_cuda.CompactCdf(tables_np.cdf, tables_np.cdf_length, "cpu")
    cap = _smem_cap(tables_np, 512, path)
    plan = rans_cuda.plan_decode(compact, (0, tables_np.cdf.shape[0]), 512, cap)
    assert (plan.shift, plan.table_in_smem, plan.smem_bytes <= cap) == (shift, path != "global", True)
    with pytest.raises(ValueError):
        rans_cuda.plan_decode(compact, (0, tables_np.cdf.shape[0]), 512, cap - 16 if path == "global" else 64)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "coarse", "global"])
def test_decode_kernel_shift_and_global_table_paths(cuda_device, tables, path):
    tables_np = tables[0]
    _decode_on_card(tables_np, cuda_device, 512, 30000, 5, smem_cap=_smem_cap(tables_np, 512, path))


@pytest.mark.cuda
def test_decode_kernel_every_lane_renormalises_every_row(cuda_device, tables):
    """Escapes on the narrowest row code its tail symbol (freq 1): 16 bits per
    cell, so all lanes take a word in the same rows and the ring wraps."""
    tables_np = tables[0]
    row = int(np.argmin(tables_np.cdf_length))
    n = 200 * 256
    idx = np.full(n, row, np.int32)
    sym = np.full(n, tables_np.offset[row] + tables_np.max_symbol[row] + 1000, np.int32)
    stage = tuple(torch.from_numpy(a) for a in (sym, idx, np.ones(n, bool)))
    _decode_on_card(tables_np, cuda_device, 256, n, 0, rows=(row, row + 1), stage=stage)


@pytest.mark.cuda
def test_decode_kernel_rejects_lanes_it_cannot_run(cuda_device, tables):
    """K = 48 is not a whole number of warps: it runs as one group of the
    grouped instance, bit for bit against the twin.  What no launch can
    hold is more lanes than 64 CTAs of 1,024 threads, and the wrapper
    refuses it before it launches anything."""
    _decode_on_card(tables[0], cuda_device, 48, 3000, 48)
    k = 65537
    launches = profiling.total("launch:rans_decode_scan")
    with pytest.raises(ValueError, match="lanes"):
        rans_cuda.rans_decode_scan(
            torch.zeros(k, dtype=torch.int32, device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device),
            torch.zeros(4, dtype=torch.int16, device=cuda_device),
            torch.zeros((1, k), dtype=torch.int32, device=cuda_device),
            torch.zeros((1, k), dtype=torch.uint8, device=cuda_device),
            torch.zeros(1 << 16, dtype=torch.int32, device=cuda_device),
            rans_device.DeviceTables.from_tables(tables[0], cuda_device).compact,
        )
    assert profiling.total("launch:rans_decode_scan") == launches


def _span_cap(tables_np, lanes, path):
    """A shared-memory cap for a stream of `lanes` lanes: the card's budget
    ("default"), or the default plan's rings without the table ("global")."""
    if path == "default":
        return None
    compact = rans_cuda.CompactCdf(tables_np.cdf, tables_np.cdf_length, "cpu")
    p = rans_cuda.plan_decode(compact, (0, tables_np.cdf.shape[0]), lanes, 232_448)
    return rans_cuda.decode_smem_bytes(p.cta_lanes, p.nrows, p.span_len, 0, p.ring_words, False, p.ctas)


def _route(lanes):
    return None if lanes <= 1024 else ("cluster" if lanes <= 8192 else "grid")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "global"])
@pytest.mark.parametrize("lanes", [48, 1056, 2048, 4096, 8192, 16384])
def test_spanning_decode_kernel_matches_twin(cuda_device, tables, lanes, path):
    """One stream at every kind of lane count: whole warps off 32 (K=48, the
    grouped instance), a cluster of 7 and 8 CTAs (K = 1056, 2048, 4096,
    8192), a cooperative grid of 16 CTAs (16384), the spanning CTAs reading
    their words from global memory; on the shared and the global table."""
    route = _route(lanes)
    before = {r: profiling.total(f"launch:{r}") for r in ("cluster", "grid")}
    _decode_on_card(tables[0], cuda_device, lanes, 24 * lanes + lanes // 3, lanes + 1,
                    smem_cap=_span_cap(tables[0], lanes, path))
    for r in ("cluster", "grid"):
        assert profiling.total(f"launch:{r}") - before[r] == (r == route)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "global"])
@pytest.mark.parametrize("lanes,groups", [(4100, 4), (4096, 2)])
def test_spanning_grouped_decode_kernel_matches_twin(cuda_device, tables, lanes, groups, path):
    """Groups wider than one CTA: kt = 1025 (staged, clusters of 7 CTAs of
    160 threads) and kt = 2048 (clusters of 8 CTAs of 256)."""
    before = profiling.total("launch:cluster")
    _grouped_on_card(tables[0], cuda_device, lanes, groups, 20 * lanes, 7,
                     smem_cap=_span_cap(tables[0], lanes // groups, path))
    assert profiling.total("launch:cluster") - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("q", [0, 5])
def test_tiny_codec_round_trip_on_card(cuda_device, q):
    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
    from progressivecodec_tpu_torch.models.weights import init_params

    model = ChannelProgressiveWACNN(TINY)
    model.load_state_dict(init_params(TINY, torch.Generator().manual_seed(0)), strict=True)
    codec = GranularCodec(model, lanes=64)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(q), dtype=torch.float32)
    n_enc = profiling.total("launch:rans_encode_scan")
    n_dec = profiling.total("launch:rans_decode_scan")
    data = codec.compress(x.to(cuda_device), quality=q, simulate=True)
    out = codec.decompress(codec.deserialize(codec.serialize(data)))
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"])
    assert profiling.total("launch:rans_encode_scan") == n_enc + 1
    assert profiling.total("launch:rans_decode_scan") == n_dec + 1 + TINY.ns0 + (q > 0)


def _grouped_on_card(tables_np, device, lanes, groups, n, seed, smem_cap=None):
    """Code two stages as PCT1-G on the CPU, decode them with the grouped
    kernel and its twin; bit for bit, one launch per stage, stream_ok."""
    t = rans_device.DeviceTables.from_tables(tables_np, "cpu")
    st = [tuple(torch.from_numpy(a) for a in _stage(tables_np, m, seed + m)) for m in (n, n // 3 + 1)]
    streams, n_words, _, _ = rans_device.encode_stages_grouped(st, t, lanes, groups)
    streams = streams.to(device)
    td = rans_device.DeviceTables.from_tables(tables_np, device)
    dec = rans_device.grouped_decoder_init(streams, lanes, groups)
    for _, idx, keep in st:
        ig = rans_device._pad_to_grid(idx, lanes).to(device)
        kg = rans_device._pad_to_grid(keep.to(torch.uint8), lanes).to(device)
        n0 = profiling.total("launch:rans_decode_scan_grouped")
        got = rans_cuda.rans_decode_scan_grouped(dec.states, dec.offsets, streams, ig, kg, td.dec_sf,
                                                 td.compact, smem_cap=smem_cap)
        torch.cuda.synchronize()
        assert profiling.total("launch:rans_decode_scan_grouped") == n0 + 1
        want = rans_cuda.rans_decode_scan_grouped_plain(dec.states, dec.offsets, streams, ig, kg, td.dec_sf)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        dec = rans_device.GroupedDecoderState(got[0], got[1], dec.esc_offsets)
    assert bool(rans_device.grouped_stream_ok(dec))
    assert torch.equal(dec.offsets.cpu(), n_words.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,groups,n", [(512, 4, 30000), (512, 16, 20000), (32, 4, 3000),
                                            (1024, 2, 20000), (64, 64, 5000), (96, 3, 4000),
                                            (64, 4, 0),
                                            # clusters of 2, 3, 6, 8, 8, 6 and 8 CTAs at kt 128,
                                            # 8, 32, 8, 128, 32 and 1 (kt % 16 != 0: staged)
                                            (256, 2, 20000), (24, 3, 3000), (192, 6, 12000),
                                            (64, 8, 5000), (1024, 8, 20000), (384, 12, 12000),
                                            (16, 16, 2000),
                                            # primes above 8: clusters of one
                                            (88, 11, 3000), (416, 13, 10000)])
def test_grouped_decode_kernel_matches_twin(cuda_device, tables, lanes, groups, n):
    _grouped_on_card(tables[0], cuda_device, lanes, groups, n, lanes + groups)


@pytest.mark.cuda
def test_grouped_decode_kernel_global_table_path(cuda_device, tables):
    tables_np = tables[0]
    _grouped_on_card(tables_np, cuda_device, 512, 4, 20000, 3,
                     smem_cap=_smem_cap(tables_np, 128, "global"))


@pytest.mark.cuda
@pytest.mark.parametrize("path,groups", [("coarse", 4), ("coarse", 16), ("global", 16)])
def test_grouped_decode_kernel_under_a_cap(cuda_device, tables, path, groups):
    """A cap that forces the coarse shift (clusters of 4 and 8, kt=128 and
    the one-warp row at kt=32), and the one-warp row on the global-table
    path (no cluster)."""
    tables_np = tables[0]
    kt = 512 // groups
    _grouped_on_card(tables_np, cuda_device, 512, groups, 20000, 4,
                     smem_cap=_smem_cap(tables_np, kt, path))


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw,groups", [({}, 4), (dict(stack_prog=False, u_net_post=1), 1),
                                             (dict(name="cnn"), 2)])
def test_tiny_codec_families_round_trip_on_card(cuda_device, model_kw, groups):
    """Grouped coding, the unrolled enhancement with the UNet refinement,
    and WACNN, each through the kernels: one encode launch and one decode
    launch per stage."""
    import dataclasses

    from progressivecodec_tpu_torch.models.codec_granular import GranularCodec
    from progressivecodec_tpu_torch.models.registry import get_model
    from progressivecodec_tpu_torch.models.weights import init_params

    cfg = dataclasses.replace(TINY, **model_kw)
    model = get_model(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(1)), strict=True)
    codec = GranularCodec(model, lanes=64, groups=groups)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(2), dtype=torch.float32)
    scans = ("launch:rans_encode_scan", "launch:rans_decode_scan", "launch:rans_decode_scan_grouped")
    before = [profiling.total(s) for s in scans]
    data = codec.compress(x.to(cuda_device), quality=5, simulate=True)
    out = codec.decompress(codec.deserialize(codec.serialize(data)))
    assert out["stream_ok"]
    assert torch.equal(out["y_hat"], data["y_hat"])
    enc, dec, grp = (profiling.total(s) - b for s, b in zip(scans, before))
    n_prog = 0 if cfg.name == "cnn" else (1 if model.stacked else cfg.num_prog_slices)
    stages = 1 + (cfg.M // cfg.dim_chunk if cfg.name == "cnn" else cfg.ns0) + n_prog
    assert (enc, dec, grp) == ((1, stages, 0) if groups == 1 else (1, 0, stages))
