"""On-device interleaved rANS (PCT1 and PCT1-G formats) in PyTorch, around
CUDA scans.

Counterpart of `progressivecodec_tpu/coder/rans_device.py`.  The flat
phases are plain PyTorch: grids, escapes, the (start, freq) pre-gather,
payload and escape compaction by cumsum + scatter, value recovery.  The
scans dispatch to `rans_cuda`: `encode_scan_rev` -> `rans_encode_scan`,
`decode_stage_scan` -> `rans_decode_scan`, `decode_stage_grouped_scan` ->
`rans_decode_scan_grouped` (kernels on CUDA tensors, plain twins on CPU
tensors).

PCT1-G splits the K lanes into G groups of kt = K/G lanes; group g's
sub-stream is the standalone PCT1 encoding of its lanes' symbols with kt
lanes.  The grouped encoder runs one encode scan over all K lanes (the
groups never interact) and compacts each group's words and escapes.

Tensor types: u32 quantities (table entries, lane states) are int32 bit
patterns, stream words int16 bit patterns, keep/flag grids uint8; payload
and escape words become np.uint16 only at serialize.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from progressivecodec_tpu_torch.coder import rans_cuda
from progressivecodec_tpu_torch.coder.rans_cuda import to_i16, to_i32, u32
from progressivecodec_tpu_torch.coder.tables import DEFAULT_LANES, RANS_L, CoderTables
from progressivecodec_tpu_torch.utils.profiling import span

I32 = torch.int32


@dataclasses.dataclass
class DeviceTables:
    """CoderTables laid out for the scans, on one device.

    enc_sf: (R*Lmax,) int32 bits of start<<16 | freq, indexed row*Lmax + sym.
    dec_sf: (R*2^16,) int32 bits of start<<16 | freq, indexed row<<16 | cum
        (the decode twin's symbol lookup).
    dec_val: (R*2^16,) int32 symbol value, indexed row<<16 | cum.
    offset, max_symbol: (R,) int32 per-row escape metadata.
    compact: the decode kernel's lookup (`rans_cuda.CompactCdf`): each row's
        CDF entries as u16, and a bucket table per row range decoded; built
        for CUDA tables only (None elsewhere: the twin reads dec_sf).
    Freq is packed into 16 bits.  For the flagship R = 256, so dec_sf and
    dec_val are 64 MiB each: build them once per codec.
    """

    enc_sf: torch.Tensor
    dec_sf: torch.Tensor
    dec_val: torch.Tensor
    lmax: int
    offset: torch.Tensor
    max_symbol: torch.Tensor
    compact: rans_cuda.CompactCdf | None

    @staticmethod
    def from_tables(t: CoderTables, device) -> "DeviceTables":
        cdf = t.cdf.astype(np.int64)
        r, lmax = cdf.shape
        freqs = np.zeros_like(cdf)
        freqs[:, :-1] = cdf[:, 1:] - cdf[:, :-1]
        enc_sf = (cdf.astype(np.uint32) << 16) | (freqs.astype(np.uint32) & 0xFFFF)

        inv = t.inverse().astype(np.int64)
        d_start = np.take_along_axis(cdf, inv, axis=1)
        d_freq = np.take_along_axis(cdf, inv + 1, axis=1) - d_start
        dec_sf = (d_start.astype(np.uint32) << 16) | (d_freq.astype(np.uint32) & 0xFFFF)
        dec_val = (inv + t.offset[:, None].astype(np.int64)).astype(np.int32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device)

        return DeviceTables(
            enc_sf=dev(enc_sf.view(np.int32)),
            dec_sf=dev(dec_sf.view(np.int32)),
            dec_val=dev(dec_val),
            lmax=lmax,
            offset=dev(t.offset.astype(np.int32)),
            max_symbol=dev(t.max_symbol.astype(np.int32)),
            compact=(rans_cuda.CompactCdf(t.cdf, t.cdf_length, device)
                     if torch.device(device).type == "cuda" else None),
        )


class DecoderState(NamedTuple):
    states: torch.Tensor  # (K,) int32 bits
    offset: torch.Tensor  # (1,) int32, next payload word
    esc_offset: torch.Tensor  # (1,) int32, next escape word


def _pad_to_grid(x: torch.Tensor, lanes: int, fill=0) -> torch.Tensor:
    n = x.shape[0]
    p = -(-n // lanes)
    pad = p * lanes - n
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(p, lanes)


def split_escapes(symbols, indexes, keep, t: DeviceTables):
    """Symbols -> (coded CDF indices int32, escape flags bool).  Out-of-support
    symbols code the row sentinel (max_symbol + 1) in-stream and their exact
    int32 value in the escape segment (see tables.py)."""
    v = symbols.to(torch.int64) - t.offset[indexes].to(torch.int64)
    maxs = t.max_symbol[indexes].to(torch.int64)
    in_sup = (v >= 0) & (v <= maxs)
    esc = keep.bool() & ~in_sup
    return torch.where(in_sup, v, maxs + 1).to(I32), esc


def _stage_grids(stages, t: DeviceTables, lanes: int):
    """Every stage's padded (P, K) grids, concatenated: (v, idx, kp, esc, sym)."""
    v_all, idx_all, kp_all, esc_all, sym_all = [], [], [], [], []
    for symbols, indexes, keep in stages:
        kp_grid = _pad_to_grid(keep.to(torch.uint8), lanes)
        idx_grid = _pad_to_grid(indexes.to(I32), lanes)
        sym_grid = _pad_to_grid(symbols.to(I32), lanes)
        v, esc = split_escapes(
            sym_grid.reshape(-1), idx_grid.reshape(-1), kp_grid.reshape(-1), t
        )
        v_all.append(v.reshape(kp_grid.shape))
        idx_all.append(idx_grid)
        kp_all.append(kp_grid)
        esc_all.append(esc.reshape(kp_grid.shape))
        sym_all.append(sym_grid)
    return tuple(torch.cat(a, dim=0) for a in (v_all, idx_all, kp_all, esc_all, sym_all))


@span("coder:encode_prepare")
def encode_prepare(stages, t: DeviceTables, lanes: int = DEFAULT_LANES):
    """Phase 1 (flat): grids + the (start, freq) pre-gather.

    stages: list of (symbols (n,), indexes (n,), keep (n,)) in decode order.
    Returns (sf_rev (P, K) int32 bits, kp_rev (P, K) uint8, esc_flags (P, K)
    bool, sym (P, K) int32), the scan inputs position-reversed."""
    v, idx, kp, esc, sym = _stage_grids(stages, t, lanes)
    sf = t.enc_sf[idx.to(torch.int64) * t.lmax + v]
    return sf.flip(0).contiguous(), kp.flip(0).contiguous(), esc, sym


@span("coder:encode_scan_rev")
def encode_scan_rev(sf_rev, kp_rev, lanes: int):
    """Phase 2: the reverse-position encode scan (CUDA kernel on the card).
    Returns (states (K,) int32 bits, words_rev (P, K) int16, flags_rev (P, K) uint8).
    The kernel takes whole warps of lanes: a grouped K that is not a
    multiple of 32 runs padded with lanes that keep nothing."""
    if sf_rev.shape[1] != lanes:
        raise ValueError(f"grid has {sf_rev.shape[1]} lanes, want {lanes}")
    pad = -lanes % 32
    if not pad:
        return rans_cuda.rans_encode_scan(sf_rev, kp_rev)
    states, words, flags = rans_cuda.rans_encode_scan(
        torch.nn.functional.pad(sf_rev, (0, pad)), torch.nn.functional.pad(kp_rev, (0, pad))
    )
    return states[:lanes], words[:, :lanes].contiguous(), flags[:, :lanes].contiguous()


@span("coder:encode_finalize")
def encode_finalize(states, words_rev, flags_rev, esc_flags, sym, lanes: int):
    """Phase 3 (flat): payload compaction, escape segment, lane-state head.
    Returns (stream (2K + P*K,) int16, n_words (), esc (2*P*K,) int16, n_esc ())."""
    words = words_rev.flip(0).reshape(-1)
    flags = flags_rev.flip(0).reshape(-1).bool()
    cap = words.shape[0]
    dev = words.device
    n_payload = flags.sum()
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    payload = torch.zeros(cap + 1, dtype=torch.int16, device=dev)
    payload.scatter_(0, torch.where(flags, pos, cap), words)

    esc_flags = esc_flags.reshape(-1)
    n_esc = esc_flags.sum()
    epos = torch.cumsum(esc_flags.to(torch.int64), 0) - 1
    raw = sym.reshape(-1).to(torch.int64)
    tgt = torch.where(esc_flags, 2 * epos, 2 * cap)
    esc = torch.zeros(2 * cap + 2, dtype=torch.int16, device=dev)
    esc.scatter_(0, tgt, to_i16(raw))
    esc.scatter_(0, tgt + 1, to_i16(raw >> 16))

    st = u32(states)
    head = torch.stack([to_i16(st), to_i16(st >> 16)], dim=1).reshape(-1)
    stream = torch.cat([head, payload[:cap]])
    return stream, n_payload + 2 * lanes, esc[: 2 * cap], n_esc


def encode_stages(stages, t: DeviceTables, lanes: int = DEFAULT_LANES):
    """One-shot composition of the three encode phases."""
    sf_rev, kp_rev, esc, sym = encode_prepare(stages, t, lanes)
    states, words_rev, flags_rev = encode_scan_rev(sf_rev, kp_rev, lanes)
    return encode_finalize(states, words_rev, flags_rev, esc, sym, lanes)


@span("coder:decoder_init")
def decoder_init(stream: torch.Tensor, lanes: int = DEFAULT_LANES) -> DecoderState:
    head = stream[: 2 * lanes].to(torch.int64) & 0xFFFF
    states = to_i32(head[0::2] | (head[1::2] << 16))
    dev = stream.device
    return DecoderState(
        states=states,
        offset=torch.full((1,), 2 * lanes, dtype=I32, device=dev),
        esc_offset=torch.zeros((1,), dtype=I32, device=dev),
    )


@span("coder:decode_stage_scan")
def decode_stage_scan(dec: DecoderState, stream, indexes_grid, keep_grid,
                      t: DeviceTables, lanes: int = DEFAULT_LANES, rows=None):
    """The decode state recursion for one stage (CUDA kernel on the card).

    indexes_grid (P, K) int32, keep_grid (P, K) uint8; `rows` = (row0, row1),
    the CDF rows the stage's kept cells use (default: all), which the kernel
    brings on chip.  Returns (states, offset, cums (P, K) int32)."""
    if indexes_grid.shape[1] != lanes:
        raise ValueError(f"grid has {indexes_grid.shape[1]} lanes, want {lanes}")
    return rans_cuda.rans_decode_scan(
        dec.states, dec.offset, stream, indexes_grid, keep_grid, t.dec_sf, t.compact, rows
    )


@span("coder:decode_stage_values")
def decode_stage_values(esc_offset, cums, esc, indexes, keep, t: DeviceTables,
                        lanes: int = DEFAULT_LANES):
    """Recover decoded values from the scan's cums (flat phase).

    One gather from dec_val; escape sentinels take their exact int32 from the
    escape segment, in order.  Returns (esc_offset', values (n,) int32)."""
    n = indexes.shape[0]
    idx = _pad_to_grid(indexes.to(I32), lanes)
    kp = _pad_to_grid(keep.bool(), lanes)
    vals = t.dec_val[(idx.to(torch.int64) << 16) + cums.to(torch.int64)]
    vals = torch.where(kp, vals, torch.zeros((), dtype=I32, device=vals.device)).reshape(-1)[:n]

    idx_f = indexes.to(torch.int64)
    sentinel = t.offset[idx_f] + t.max_symbol[idx_f] + 1
    esc_flag = keep.bool() & (vals == sentinel)
    n_esc = esc_flag.sum()
    j = esc_offset.to(torch.int64) + 2 * (torch.cumsum(esc_flag.to(torch.int64), 0) - 1)
    safe = torch.where(esc_flag, j, 0).clamp(0, esc.shape[0] - 2)
    words = esc.to(torch.int64) & 0xFFFF
    raw = to_i32(words[safe] | (words[safe + 1] << 16))
    vals = torch.where(esc_flag, raw, vals)
    return esc_offset + 2 * n_esc.to(I32), vals


def stream_ok(dec) -> torch.Tensor:
    """Every lane state back at L: the end-to-end integrity signal (a
    DecoderState or a GroupedDecoderState)."""
    return (u32(dec.states) == RANS_L).all()


# ---------------------------------------------------------------------------
# PCT1-G: G independent sub-streams of kt = K/G lanes
# ---------------------------------------------------------------------------


class GroupedDecoderState(NamedTuple):
    states: torch.Tensor  # (K,) int32 bits, all groups' lane states
    offsets: torch.Tensor  # (G,) int32, each group's next payload word
    esc_offsets: torch.Tensor  # (G,) int32, each group's next escape word


grouped_stream_ok = stream_ok


def _to_groups(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(P, K) -> (G, P*kt): each group's cells in (position, local lane) order."""
    p, k = x.shape
    return x.reshape(p, groups, k // groups).transpose(0, 1).reshape(groups, -1)


@span("coder:encode_stages_grouped")
def encode_stages_grouped(stages, t: DeviceTables, lanes: int = DEFAULT_LANES, groups: int = 1):
    """All stages as G sub-streams.  Returns (streams (G, 2kt + P*kt) int16,
    n_words (G,), escs (G, 2*P*kt) int16, n_escs (G,)); the words of group g
    are byte-identical to the single-stream encoding of its lanes with kt
    lanes."""
    if lanes % groups:
        raise ValueError(f"lanes {lanes} is not a multiple of groups {groups}")
    kt = lanes // groups
    sf_rev, kp_rev, esc_flags, sym = encode_prepare(stages, t, lanes)
    states, words_rev, flags_rev = encode_scan_rev(sf_rev, kp_rev, lanes)
    gw = _to_groups(words_rev.flip(0), groups)
    gf = _to_groups(flags_rev.flip(0), groups).bool()
    cap = gw.shape[1]
    dev = gw.device
    pos = torch.cumsum(gf.to(torch.int64), 1) - 1
    payload = torch.zeros((groups, cap + 1), dtype=torch.int16, device=dev)
    payload.scatter_(1, torch.where(gf, pos, cap), gw)

    ge = _to_groups(esc_flags, groups)
    epos = torch.cumsum(ge.to(torch.int64), 1) - 1
    raw = _to_groups(sym, groups).to(torch.int64)
    tgt = torch.where(ge, 2 * epos, 2 * cap)
    escs = torch.zeros((groups, 2 * cap + 2), dtype=torch.int16, device=dev)
    escs.scatter_(1, tgt, to_i16(raw))
    escs.scatter_(1, tgt + 1, to_i16(raw >> 16))

    st = u32(states).reshape(groups, kt)
    head = torch.stack([to_i16(st), to_i16(st >> 16)], dim=2).reshape(groups, 2 * kt)
    streams = torch.cat([head, payload[:, :cap]], dim=1)
    return streams, gf.sum(1) + 2 * kt, escs[:, : 2 * cap], ge.sum(1)


@span("coder:grouped_decoder_init")
def grouped_decoder_init(streams: torch.Tensor, lanes: int, groups: int) -> GroupedDecoderState:
    """streams (G, W) int16: each row a PCT1 sub-stream of kt = K/G lanes."""
    kt = lanes // groups
    head = streams[:, : 2 * kt].to(torch.int64) & 0xFFFF
    dev = streams.device
    return GroupedDecoderState(
        states=to_i32(head[:, 0::2] | (head[:, 1::2] << 16)).reshape(-1),
        offsets=torch.full((groups,), 2 * kt, dtype=I32, device=dev),
        esc_offsets=torch.zeros((groups,), dtype=I32, device=dev),
    )


@span("coder:decode_stage_grouped_scan")
def decode_stage_grouped_scan(dec: GroupedDecoderState, streams, indexes_grid, keep_grid,
                              t: DeviceTables, lanes: int = DEFAULT_LANES, rows=None):
    """The decode state recursion of one stage for every group in one
    launch (CUDA kernel on the card).  Returns (states, offsets, cums)."""
    if indexes_grid.shape[1] != lanes:
        raise ValueError(f"grid has {indexes_grid.shape[1]} lanes, want {lanes}")
    return rans_cuda.rans_decode_scan_grouped(
        dec.states, dec.offsets, streams, indexes_grid, keep_grid, t.dec_sf, t.compact, rows
    )


@span("coder:decode_stage_grouped_values")
def decode_stage_grouped_values(esc_offsets, cums, escs, indexes, keep, t: DeviceTables,
                                lanes: int, groups: int):
    """Decoded values in global symbol order from the grouped scan's cums;
    escape sentinels take their exact int32 from their group's escape row
    (G, E), in group order.  Returns (esc_offsets', values (n,) int32)."""
    n = indexes.shape[0]
    idx = _pad_to_grid(indexes.to(I32), lanes)
    kp = _pad_to_grid(keep.bool(), lanes)
    p = idx.shape[0]
    vals = t.dec_val[(idx.to(torch.int64) << 16) + cums.to(torch.int64)]
    vals = torch.where(kp, vals, torch.zeros((), dtype=I32, device=vals.device))
    idx_g = _to_groups(idx, groups).to(torch.int64)
    vals_g = _to_groups(vals, groups)
    sentinel = t.offset[idx_g] + t.max_symbol[idx_g] + 1
    esc_flag = _to_groups(kp, groups) & (vals_g == sentinel)
    n_esc = esc_flag.sum(1)
    j = esc_offsets.to(torch.int64)[:, None] + 2 * (torch.cumsum(esc_flag.to(torch.int64), 1) - 1)
    safe = torch.where(esc_flag, j, 0).clamp(0, escs.shape[1] - 2)
    words = escs.to(torch.int64) & 0xFFFF
    raw = to_i32(words.gather(1, safe) | (words.gather(1, safe + 1) << 16))
    vals_g = torch.where(esc_flag, raw, vals_g)
    vals = vals_g.reshape(groups, p, lanes // groups).transpose(0, 1).reshape(-1)[:n]
    return esc_offsets + 2 * n_esc.to(I32), vals
