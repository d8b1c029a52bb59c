"""The rANS scans: CUDA kernels for Hopper and their plain PyTorch twins.

  rans_encode_scan          replaces coder/rans_pallas.py:encode_scan_rev_pallas
                            (csrc/rans_encode.cu)
  rans_decode_scan          replaces coder/rans_device.py:decode_stage_scan
                            (csrc/rans_decode.cu)
  rans_decode_scan_grouped  replaces coder/rans_device.py:decode_stage_grouped,
                            the PCT1-G scan (csrc/rans_decode.cu, one CTA
                            per group, in clusters of `decode_cluster(G)`)

A stream or group of more than 1,024 lanes spans C CTAs (`decode_span`):
a thread-block cluster for C <= 8, a cooperative grid above, counted as
`launch:cluster` and `launch:grid` besides the wrapper's own count.  A
single stream whose K is not a whole number of warps up to 1,024 runs as
one group of the grouped instance.

Each wrapper takes its route from the device of its tensors: a CPU tensor
goes to the plain twin, a CUDA tensor launches the kernel.  On CUDA there
is no fallback: a failed build or launch raises.  Each wrapper counts its
kernel launches as `launch:<wrapper>` (`utils/profiling.count`).

Unsigned 32-bit quantities travel as int32 bit patterns, 16-bit words as
int16 bit patterns and flags as uint8, because PyTorch implements almost
nothing for torch.uint32.  The twins compute in int64 and mask to 32 bits;
the kernels read the same bits as uint32_t / uint16_t.

The decode kernel finds each symbol in a compact CDF table that it brings
into shared memory (`plan_decode` sizes it; the grouped launch by bulk
copies multicast over a thread-block cluster); its twin reads the 64 MiB
`dec_sf` table, so the two reach the symbol by different routes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from progressivecodec_tpu_torch import build
from progressivecodec_tpu_torch.coder.tables import RANS_L
from progressivecodec_tpu_torch.utils.profiling import count

_U32 = 0xFFFFFFFF
_VP = ctypes.c_void_p


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 with the same bits."""
    x = x & _U32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def to_i16(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int16 holding the bits of its low 16 bits."""
    x = x.to(torch.int64) & 0xFFFF
    return (x - ((x & 0x8000) << 1)).to(torch.int16)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the u32 value."""
    return x.to(torch.int64) & _U32


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {ndim}-D {dtype} tensor, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")


@functools.lru_cache(maxsize=None)
def _fn(lib: str, name: str, *argtypes):
    f = getattr(build.library(lib), name)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def _stream(device) -> _VP:
    return _VP(torch.cuda.current_stream(device).cuda_stream)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels copy rows 16 bytes at a time: a tensor whose data does
    not start on a 16-byte boundary is copied to one that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).shared_memory_per_block_optin)


# ---------------------------------------------------------------------------
# encode scan
# ---------------------------------------------------------------------------


def rans_encode_scan_plain(sf_rev: torch.Tensor, kp_rev: torch.Tensor):
    """Reverse-position encode over pre-gathered (start<<16 | freq).

    sf_rev (P, K) int32 bits, kp_rev (P, K) uint8.  Returns (states (K,)
    int32 bits, words (P, K) int16 bits, flags (P, K) uint8)."""
    p, k = sf_rev.shape
    x = torch.full((k,), RANS_L, dtype=torch.int64, device=sf_rev.device)
    words = torch.empty((p, k), dtype=torch.int16, device=sf_rev.device)
    flags = torch.empty((p, k), dtype=torch.uint8, device=sf_rev.device)
    sf = u32(sf_rev)
    one = torch.ones((), dtype=torch.int64, device=sf_rev.device)
    for r in range(p):
        keep = kp_rev[r] != 0
        start = sf[r] >> 16
        freq = torch.where(keep, sf[r] & 0xFFFF, one)
        flag = keep & (x >= (freq << 16))
        words[r] = to_i16(x)
        flags[r] = flag.to(torch.uint8)
        x = torch.where(flag, x >> 16, x)
        x = torch.where(keep, (((x // freq) << 16) + x % freq + start) & _U32, x)
    return to_i32(x), words, flags


def rans_encode_scan(sf_rev: torch.Tensor, kp_rev: torch.Tensor):
    """Same contract as `rans_encode_scan_plain`; launches the CUDA kernel
    (CTAs of 32 lanes; needs K % 32 == 0) for CUDA tensors."""
    dev = sf_rev.device
    _check("sf_rev", sf_rev, torch.int32, 2, dev)
    _check("kp_rev", kp_rev, torch.uint8, 2, dev)
    if kp_rev.shape != sf_rev.shape:
        raise ValueError(f"kp_rev {tuple(kp_rev.shape)} != sf_rev {tuple(sf_rev.shape)}")
    if dev.type == "cpu":
        return rans_encode_scan_plain(sf_rev, kp_rev)
    if dev.type != "cuda":
        raise ValueError(f"rans_encode_scan: unsupported device {dev}")
    p, k = sf_rev.shape
    if k % 32 or k < 32:
        raise ValueError(f"rans_encode_scan kernel needs lanes a positive multiple of 32; got {k}")
    sf_rev, kp_rev = _aligned(sf_rev), _aligned(kp_rev)
    states = torch.empty((k,), dtype=torch.int32, device=dev)
    words = torch.empty((p, k), dtype=torch.int16, device=dev)
    flags = torch.empty((p, k), dtype=torch.uint8, device=dev)
    fn = _fn("rans_encode", "rans_encode_scan", _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP)
    rc = fn(sf_rev.data_ptr(), kp_rev.data_ptr(), states.data_ptr(), words.data_ptr(),
            flags.data_ptr(), p, k, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rans_encode_scan kernel launch failed: cudaError {rc}")
    count("launch:rans_encode_scan")
    return states, words, flags



# ---------------------------------------------------------------------------
# decode scan
# ---------------------------------------------------------------------------


def rans_decode_scan_plain(states: torch.Tensor, offset: torch.Tensor, stream: torch.Tensor,
                           idx: torch.Tensor, kp: torch.Tensor, dec_sf: torch.Tensor):
    """Decode state recursion of one stage.

    states (K,) int32 bits, offset (1,) int32, stream (W,) int16 bits (reads
    past its end give 0), idx (P, K) int32 CDF rows, kp (P, K) uint8,
    dec_sf (R*2^16,) int32 bits.  Returns (states (K,) int32 bits, offset
    (1,) int32, cums (P, K) int32).  The one-group case of
    `rans_decode_scan_grouped_plain`."""
    return rans_decode_scan_grouped_plain(states, offset, stream[None], idx, kp, dec_sf)


def rans_decode_scan_grouped_plain(states: torch.Tensor, offsets: torch.Tensor,
                                   streams: torch.Tensor, idx: torch.Tensor, kp: torch.Tensor,
                                   dec_sf: torch.Tensor):
    """The same recursion for G groups of kt = K/G lanes (PCT1-G): group g
    owns lanes [g*kt, (g+1)*kt), reads stream row g from offsets[g], and
    ranks its renorm words within the group.

    offsets (G,) int32, streams (G, W) int16 bits (reads past W give 0).
    Returns (states (K,), offsets (G,), cums (P, K))."""
    p, k = idx.shape
    g = streams.shape[0]
    kt = k // g
    dev = states.device
    x = u32(states).reshape(g, kt)
    off = offsets.to(torch.int64)
    words = streams.to(torch.int64) & 0xFFFF
    n = words.shape[1]
    cums = torch.empty((p, k), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(p):
        keep = (kp[r] != 0).reshape(g, kt)
        cum = x & 0xFFFF
        cums[r] = cum.reshape(-1).to(torch.int32)
        lin = torch.where(keep, (idx[r].to(torch.int64).reshape(g, kt) << 16) + cum, zero)
        sf = u32(dec_sf[lin])
        adv = ((sf & 0xFFFF) * (x >> 16) + cum - (sf >> 16)) & _U32
        flag = keep & (adv < RANS_L)
        fl = flag.to(torch.int64)
        pos = off[:, None] + torch.cumsum(fl, 1) - fl
        word = (torch.where(pos < n, words.gather(1, pos.clamp(max=n - 1)), zero) if n
                else torch.zeros_like(pos))
        adv = torch.where(flag, ((adv << 16) | word) & _U32, adv)
        x = torch.where(keep, adv, x)
        off = off + fl.sum(1)
    return to_i32(x.reshape(-1)), off.to(torch.int32), cums


# Constants shared with csrc/rans_decode.cu.
DECODE_REFILL = 4  # rows from a ring refill to the next (kRefill)
DECODE_SLOTS = 2 * DECODE_REFILL + 1  # rows of idx / keep in the ring (kSlots)
STREAM_CHUNK = 256  # stream words per warp copy (kChunk)
MAX_CLUSTER = 8  # CTAs per cluster, the portable size (kMaxCluster)
MAX_CTA_LANES = 1024  # threads of one decode CTA
MAX_SPAN = 64  # CTAs of one stream on the grid path: 65,535 lanes in CTAs of 1,024 (kMaxSpan)
SPAN_XCHG_BYTES = 2 * MAX_SPAN * 4 + 16  # the row totals' slots, two rows, and two row barriers
SHIFTS = range(6, 17)  # bucket widths 2^6 .. 2^16 cums
RUN_FLAG = 1 << 15  # bucket of freq-1 symbols only (kRunFlag)


def bucket_stride(shift: int) -> int:
    """Entries per row of the bucket table at `shift`: 2^(16-shift) buckets
    and the row's last symbol, padded to a multiple of 8."""
    return ((1 << (16 - shift)) + 1 + 7) // 8 * 8


class CompactCdf:
    """The decode kernel's symbol lookup tables, on one device.

    starts: (E,) int16 bits.  Row r holds its n_r + 1 CDF entries (symbol
        starts, then 65536 stored as 0) from starts[base_r], rows padded to
        multiples of 8 entries.
    meta: (R, 2) int32 {base_r, n_r}.
    row_base: (R + 1,) host int64 copy of the bases, so that the entries of a
        row range are known without a device-to-host copy.

    A launch reads the bucket table of its stage's rows at one shift
    (`bucket_rows`); `buckets` builds it on first use and keeps it, and
    `plan_decode` keeps each launch plan, so a codec holds one table per
    row range it decodes.
    """

    def __init__(self, cdf: np.ndarray, cdf_length: np.ndarray, device):
        """From a padded CDF matrix (R, Lmax) whose row r holds
        n_r = cdf_length[r] - 1 symbols, cdf[r, n_r] = 65536."""
        cdf = np.asarray(cdf, dtype=np.int64)
        n = np.asarray(cdf_length, dtype=np.int64) - 1
        if n.max() >= RUN_FLAG:
            raise ValueError(f"a CDF row has {n.max()} symbols; the bucket table holds < {RUN_FLAG}")
        base = np.zeros(cdf.shape[0] + 1, dtype=np.int64)
        base[1:] = np.cumsum((n + 1 + 7) // 8 * 8)
        starts = np.zeros(int(base[-1]), dtype=np.uint16)
        for i in range(cdf.shape[0]):
            starts[base[i] : base[i] + n[i] + 1] = cdf[i, : n[i] + 1] & 0xFFFF
        self.starts = torch.from_numpy(starts.view(np.int16)).to(device)
        self.meta = torch.from_numpy(np.stack([base[:-1], n], axis=1).astype(np.int32)).to(device)
        self.device = self.starts.device
        self.row_base = base
        self._cdf, self._n = cdf, n
        self._buckets: dict = {}
        self.plans: dict = {}

    def bucket_rows(self, rows, shift: int) -> np.ndarray:
        """The bucket table of CDF rows [row0, row1) at `shift`: uint16
        (row1 - row0, bucket_stride(shift)).  Entry [r, b] is the symbol
        whose range holds cum = b << shift for b < 2^(16-shift), then
        n_r - 1; bit 15 (RUN_FLAG) marks a bucket whose cums all fall in
        symbols of freq 1, where the symbol's start is cum itself."""
        nb = 1 << (16 - shift)
        probe = np.arange(nb, dtype=np.int64) << shift
        tab = np.empty((rows[1] - rows[0], bucket_stride(shift)), dtype=np.uint16)
        for j, i in enumerate(range(*rows)):
            n = self._n[i]
            row = self._cdf[i, : n + 1]
            lo = np.searchsorted(row[:n], probe, side="right") - 1
            hi = np.searchsorted(row[:n], probe + (1 << shift) - 1, side="right") - 1
            ones = np.concatenate([[0], np.cumsum(np.diff(row) == 1)])
            run = ones[hi + 1] - ones[lo] == hi - lo + 1
            tab[j, :nb] = lo | np.where(run, RUN_FLAG, 0)
            tab[j, nb:] = n - 1
        return tab

    def buckets(self, rows, shift: int) -> torch.Tensor:
        """`bucket_rows(rows, shift)` on the device as flat int16 bits, built
        on first use."""
        key = (tuple(rows), shift)
        if key not in self._buckets:
            tab = self.bucket_rows(rows, shift).reshape(-1).view(np.int16)
            self._buckets[key] = torch.from_numpy(tab).to(self.device)
        return self._buckets[key]


class DecodePlan(NamedTuple):
    """How one decode launch lays out its dynamic shared memory, and how
    many CTAs each stream (or group) spans."""

    row0: int
    nrows: int
    span_base: int  # first entry of the rows in CompactCdf.starts
    span_len: int
    shift: int  # cum >> shift picks the bucket
    bucket_stride: int
    ring_words: int  # stream ring; 0 (a spanning stream): the words are read from global memory
    table_in_smem: bool  # False: the search reads the table in global memory
    smem_bytes: int
    ctas: int  # CTAs per stream or group
    cta_lanes: int  # threads per CTA
    grid: bool  # the CTAs exchange row totals through global memory (C > 8)


def decode_smem_bytes(lanes, nrows, span_len, bucket_stride, ring_words, table_in_smem,
                      ctas: int = 1) -> int:
    """Dynamic shared memory of one decode CTA of `lanes` threads whose
    stream spans `ctas` CTAs; the layout of csrc/rans_decode.cu (`layout`)."""
    r16 = lambda b: (b + 15) // 16 * 16  # noqa: E731
    total = 64  # warp counts
    if table_in_smem:
        total += r16(nrows * 2) + r16(span_len * 2) + r16(nrows * bucket_stride * 2)
    total += DECODE_SLOTS * lanes * 5 + ring_words * 2 + 16  # the rings, the table's mbarrier
    return total + (SPAN_XCHG_BYTES if ctas > 1 else 0)


def decode_cluster(groups: int) -> int:
    """CTAs per thread-block cluster of a grouped decode launch with an
    on-chip table: the largest divisor of `groups` up to MAX_CLUSTER (1 for
    a prime above it)."""
    return max(c for c in range(1, min(groups, MAX_CLUSTER) + 1) if groups % c == 0)


def warp_lanes(kt: int) -> int:
    """Threads of one decode CTA for kt lanes: whole warps."""
    return -(-kt // 32) * 32


def decode_span(kt: int) -> tuple[int, int, bool]:
    """(C, w, grid): a stream or group of kt lanes runs on C CTAs of w
    threads.  Up to 1,024 lanes, one CTA.  Above, a full cluster: w = kt /
    MAX_CLUSTER in whole warps (on an H100 the exchange cost about the same
    at 2 to 8 CTAs, and a narrower CTA's row is shorter: PERF.md); CTAs of
    1,024 lanes where that would take more than MAX_CLUSTER.  grid is True
    where it still does (kt > 8,192), and the CTAs then run as a
    cooperative grid rather than a cluster."""
    if not 1 <= kt <= MAX_SPAN * MAX_CTA_LANES:
        raise ValueError(f"lanes per stream must lie in [1, {MAX_SPAN * MAX_CTA_LANES}], got {kt}")
    if kt <= MAX_CTA_LANES:
        return 1, warp_lanes(kt), False
    c = MAX_CLUSTER if kt <= MAX_CLUSTER * MAX_CTA_LANES else -(-kt // MAX_CTA_LANES)
    w = warp_lanes(-(-kt // c))
    c = -(-kt // w)  # so the last CTA holds at least one lane
    return c, w, c > MAX_CLUSTER


def plan_decode(compact: CompactCdf, rows, lanes: int, smem_cap: int) -> DecodePlan:
    """The launch plan of a stream (or group) of `lanes` lanes: its CTAs
    (`decode_span`), then the finest bucket shift at which the stage's rows,
    the idx / keep ring and the stream ring of each CTA fit `smem_cap`
    bytes, else the global-table path.  A stream of several CTAs has no
    stream ring (ring_words 0): its lanes read their words from the stream
    in global memory.  Kept in `compact.plans`.  Raises ValueError if not
    even the rings fit."""
    key = (tuple(rows), lanes, smem_cap)
    if key not in compact.plans:
        compact.plans[key] = _plan_decode(compact, rows, lanes, smem_cap)
    return compact.plans[key]


def _plan_decode(compact: CompactCdf, rows, lanes: int, smem_cap: int) -> DecodePlan:
    row0, row1 = rows
    if not 0 <= row0 < row1 <= compact.meta.shape[0]:
        raise ValueError(f"rows {rows} outside the table's {compact.meta.shape[0]} rows")
    ctas, w, grid = decode_span(lanes)
    nrows = row1 - row0
    span_base = int(compact.row_base[row0])
    span_len = int(compact.row_base[row1]) - span_base
    ring = 0 if ctas > 1 else 1 << (2 * DECODE_REFILL * w + STREAM_CHUNK - 1).bit_length()
    span = dict(ctas=ctas, cta_lanes=w, grid=grid)
    for shift in SHIFTS if span_len <= 1 << 16 else ():  # u16 row bases in shared memory
        stride = bucket_stride(shift)
        b = decode_smem_bytes(w, nrows, span_len, stride, ring, True, ctas)
        if b <= smem_cap:
            return DecodePlan(row0, nrows, span_base, span_len, shift, stride, ring, True, b, **span)
    b = decode_smem_bytes(w, nrows, span_len, 0, ring, False, ctas)
    if b > smem_cap:
        raise ValueError(f"decode rings need {b} bytes of shared memory, the cap is {smem_cap}")
    return DecodePlan(row0, nrows, span_base, span_len, 16, 0, ring, False, b, **span)


def _smem_cap(dev, smem_cap):
    return smem_cap or _smem_optin(torch.cuda.current_device() if dev.index is None else dev.index)


def rans_decode_scan(states: torch.Tensor, offset: torch.Tensor, stream: torch.Tensor,
                     idx: torch.Tensor, kp: torch.Tensor, dec_sf: torch.Tensor,
                     compact: CompactCdf | None = None, rows=None, *, smem_cap: int | None = None):
    """Same contract as `rans_decode_scan_plain`; launches the CUDA kernel
    for CUDA tensors: one CTA of K threads when K is a multiple of 32 up to
    1,024; else the grouped instance with one group (K < 32 or K % 32 != 0)
    or C CTAs (K > 1,024, `decode_span`).

    The kernel looks symbols up in `compact` (required on CUDA), restricted
    to the CDF rows [row0, row1) = `rows` (default: all), which every kept
    cell's idx must lie in.  `smem_cap` lowers the shared-memory budget
    (default: the card's opt-in maximum); a cap too small for the table
    selects the global-table path."""
    dev = states.device
    _check("states", states, torch.int32, 1, dev)
    _check("offset", offset, torch.int32, 1, dev)
    _check("stream", stream, torch.int16, 1, dev)
    _check("idx", idx, torch.int32, 2, dev)
    _check("kp", kp, torch.uint8, 2, dev)
    _check("dec_sf", dec_sf, torch.int32, 1, dev)
    p, k = idx.shape
    if kp.shape != idx.shape or states.shape[0] != k or offset.shape[0] != 1:
        raise ValueError("rans_decode_scan: inconsistent shapes")
    if dev.type == "cpu":
        return rans_decode_scan_plain(states, offset, stream, idx, kp, dec_sf)
    if dev.type != "cuda":
        raise ValueError(f"rans_decode_scan: unsupported device {dev}")
    if compact is None or compact.device != dev:
        raise ValueError(f"rans_decode_scan kernel needs the CompactCdf tables on {dev}")
    if k % 32 or k > MAX_CTA_LANES:
        out = _launch_groups(states, offset, stream[None], idx, kp, compact, rows, _smem_cap(dev, smem_cap))
        count("launch:rans_decode_scan")
        return out
    cap = _smem_cap(dev, smem_cap)
    rows = rows or (0, compact.meta.shape[0])
    plan = plan_decode(compact, rows, k, cap)
    stream, idx, kp = _aligned(stream), _aligned(idx), _aligned(kp)
    # the stage's rows of the bucket table at plan.shift
    buckets = compact.buckets(rows, plan.shift).data_ptr() if plan.table_in_smem else 0
    states_out = torch.empty((k,), dtype=torch.int32, device=dev)
    offset_out = torch.empty((1,), dtype=torch.int32, device=dev)
    cums = torch.empty((p, k), dtype=torch.int32, device=dev)
    ci = ctypes.c_int
    fn = _fn("rans_decode", "rans_decode_scan", _VP, _VP, _VP, ctypes.c_longlong, _VP, _VP, _VP,
             _VP, _VP, ci, ci, ci, ci, ci, ci, ci, ci, ci, _VP, _VP, _VP, ci, ci, _VP)
    rc = fn(states.data_ptr(), offset.data_ptr(), stream.data_ptr(), stream.numel(),
            idx.data_ptr(), kp.data_ptr(), compact.starts.data_ptr(), buckets,
            compact.meta.data_ptr(), plan.row0, plan.nrows, plan.span_base, plan.span_len,
            plan.shift, plan.bucket_stride, plan.ring_words, int(plan.table_in_smem), cap,
            states_out.data_ptr(), offset_out.data_ptr(),
            cums.data_ptr(), p, k, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rans_decode_scan kernel launch failed: cudaError {rc}")
    count("launch:rans_decode_scan")
    return states_out, offset_out, cums



def rans_decode_scan_grouped(states: torch.Tensor, offsets: torch.Tensor, streams: torch.Tensor,
                             idx: torch.Tensor, kp: torch.Tensor, dec_sf: torch.Tensor,
                             compact: CompactCdf | None = None, rows=None, *,
                             smem_cap: int | None = None):
    """Same contract as `rans_decode_scan_grouped_plain`; for CUDA tensors
    one launch: G CTAs, one per group, of kt lanes rounded up to whole
    warps (kt <= 1,024), in clusters of `decode_cluster(G)` CTAs that share
    the on-chip table's copies (no cluster on the global-table path); or,
    for kt > 1,024, G times C CTAs (`decode_span`), each group a cluster of
    C CTAs or, above 8, a share of a cooperative grid.  `compact`, `rows` and `smem_cap` as for
    `rans_decode_scan`."""
    dev = states.device
    _check("states", states, torch.int32, 1, dev)
    _check("offsets", offsets, torch.int32, 1, dev)
    _check("streams", streams, torch.int16, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    _check("kp", kp, torch.uint8, 2, dev)
    _check("dec_sf", dec_sf, torch.int32, 1, dev)
    p, k = idx.shape
    g = streams.shape[0]
    if (kp.shape != idx.shape or states.shape[0] != k or offsets.shape[0] != g or g < 1
            or k % g):
        raise ValueError("rans_decode_scan_grouped: inconsistent shapes")
    if dev.type == "cpu":
        return rans_decode_scan_grouped_plain(states, offsets, streams, idx, kp, dec_sf)
    if dev.type != "cuda":
        raise ValueError(f"rans_decode_scan_grouped: unsupported device {dev}")
    if compact is None or compact.device != dev:
        raise ValueError(f"rans_decode_scan_grouped kernel needs the CompactCdf tables on {dev}")
    out = _launch_groups(states, offsets, streams, idx, kp, compact, rows, _smem_cap(dev, smem_cap))
    count("launch:rans_decode_scan_grouped")
    return out



def _launch_groups(states, offsets, streams, idx, kp, compact, rows, cap):
    """One launch of the decode kernel over G = streams.shape[0] streams of
    kt = K/G lanes: the grouped entry (one CTA per group) for kt <= 1,024,
    the span entry (C CTAs per group) above.  Returns (states, offsets,
    cums)."""
    dev = states.device
    p, k = idx.shape
    g = streams.shape[0]
    kt = k // g
    rows = rows or (0, compact.meta.shape[0])
    plan = plan_decode(compact, rows, kt, cap)
    lanes, ctas = plan.cta_lanes, plan.ctas
    width = ctas * lanes  # a group's columns, padded to whole CTAs when staged
    if g > 1 and streams.shape[1] % 8:  # rows 16 bytes apart; the zeros read as past the end
        streams = torch.nn.functional.pad(streams, (0, -streams.shape[1] % 8))
    if kt % 16:
        # the kernel copies 16 bytes at a time: stage each group's columns
        # into a block of whole CTAs, padding lanes keeping nothing
        idx = torch.nn.functional.pad(idx.reshape(p, g, kt), (0, width - kt)).transpose(0, 1).contiguous()
        kp = torch.nn.functional.pad(kp.reshape(p, g, kt), (0, width - kt)).transpose(0, 1).contiguous()
        in_group, in_row = p * width, width
    else:
        in_group, in_row = kt, k
    streams, idx, kp = _aligned(streams), _aligned(idx), _aligned(kp)
    buckets = compact.buckets(rows, plan.shift).data_ptr() if plan.table_in_smem else 0
    states_out = torch.empty((k,), dtype=torch.int32, device=dev)
    offsets_out = torch.empty((g,), dtype=torch.int32, device=dev)
    cums = torch.empty((p, k), dtype=torch.int32, device=dev)
    ci, cl = ctypes.c_int, ctypes.c_longlong
    common = (states.data_ptr(), offsets.data_ptr(), streams.data_ptr(), streams.shape[1],
              idx.data_ptr(), kp.data_ptr(), in_group, in_row, compact.starts.data_ptr(), buckets,
              compact.meta.data_ptr(), plan.row0, plan.nrows, plan.span_base, plan.span_len,
              plan.shift, plan.bucket_stride, plan.ring_words, int(plan.table_in_smem), cap,
              states_out.data_ptr(), offsets_out.data_ptr(), cums.data_ptr(), p, g, kt, lanes)
    argtypes = (_VP, _VP, _VP, cl, _VP, _VP, cl, ci, _VP, _VP, _VP, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                _VP, _VP, _VP, ci, ci, ci, ci)
    if ctas == 1:
        cluster = decode_cluster(g) if plan.table_in_smem else 1
        fn = _fn("rans_decode", "rans_decode_scan_grouped", *argtypes, ci, _VP)
        rc = fn(*common, cluster, _stream(dev))
        what = f"clusters of {cluster}"
    else:
        route = "grid" if plan.grid else "cluster"
        # the grid's row totals, tagged with their row; -1 matches no row
        xchg = torch.full((g * 2 * ctas,), -1, dtype=torch.int32, device=dev) if plan.grid else None
        fn = _fn("rans_decode", "rans_decode_scan_span", *argtypes, ci, ci, _VP, _VP)
        rc = fn(*common, ctas, int(plan.grid), xchg.data_ptr() if plan.grid else 0, _stream(dev))
        what = (f"a cooperative grid of {g * ctas} CTAs" if plan.grid else
                f"{g} clusters of {ctas} CTAs") + f" of {lanes} threads"
    if rc != 0:
        raise RuntimeError(f"rans_decode kernel launch failed ({what}): cudaError {rc}")
    if ctas > 1:
        count(f"launch:{route}")
    return states_out, offsets_out, cums
