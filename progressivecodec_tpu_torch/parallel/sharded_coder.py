"""Sharded entropy coding: the PCT1-G lane groups, one per rank of a mesh axis.

Counterpart of `progressivecodec_tpu/parallel/sharded_coder.py`.  PCT1-G
(coder/rans_device.py) splits the K lanes into G independent sub-streams of
kt = K/G lanes.  Here rank g of the axis codes group g with the repo's
kernels, on its own device:
  * encode: every rank runs the flat `encode_prepare` over all stages,
    takes its (P, kt) lane block and runs the encode kernel
    (`rans_cuda.rans_encode_scan`, through `rans_device.encode_scan_rev`,
    which pads a kt that is not a whole number of warps with lanes that
    keep nothing) and `encode_finalize` on it; an all_gather gives every
    rank all G sub-streams, byte-identical to
    `rans_device.encode_stages(..., groups=G)`;
  * decode, stage by stage (a later slice's parameters depend on the
    values decoded before it): rank g decodes its block from its own
    sub-stream, the coder's path at one group of kt lanes (one decode
    launch: one CTA, or for kt > 1,024 a cluster or grid of CTAs),
    resolves its escapes, and an all_gather puts every rank's values back
    in global symbol order, with the decoder state of every group.
The wire format does not depend on the topology: a sharded container
decodes with `GranularCodec(groups=G)` and the other way round.
"""

from __future__ import annotations

import torch

from progressivecodec_tpu_torch.coder import rans_cuda, rans_device
from progressivecodec_tpu_torch.coder.rans_device import DecoderState, DeviceTables
from progressivecodec_tpu_torch.parallel.distributed import all_gather
from progressivecodec_tpu_torch.parallel.mesh import check_axis

I32 = torch.int32


def _group(mesh, axis: str, lanes: int):
    """(G, kt, this rank's group, the axis's process group)."""
    check_axis(mesh, axis)
    groups = mesh[axis].size()
    if lanes % groups:
        raise ValueError(f"lanes {lanes} is not a multiple of the {groups} ranks of {axis!r}")
    return groups, lanes // groups, mesh.get_local_rank(axis), mesh.get_group(axis)


def _block(grid: torch.Tensor, g: int, kt: int) -> torch.Tensor:
    """Group g's columns of a (P, K) grid, (P, kt)."""
    return grid[:, g * kt : (g + 1) * kt].contiguous()


def sharded_encode_stages(stages, t: DeviceTables, lanes: int, mesh, axis: str = "model"):
    """Encode with one lane group per rank of `axis`.  Returns (streams (G,
    2kt + P*kt) int16, n_words (G,), escs (G, 2*P*kt) int16, n_escs (G,))
    on every rank, the results of `rans_device.encode_stages(..., groups=G)`."""
    groups, kt, g, pg = _group(mesh, axis, lanes)
    sf_rev, kp_rev, esc_flags, sym = rans_device.encode_prepare(stages, t, lanes)
    states, words_rev, flags_rev = rans_device.encode_scan_rev(
        _block(sf_rev, g, kt), _block(kp_rev, g, kt), kt)
    stream, n_words, esc, n_esc = rans_device.encode_finalize(
        states, words_rev, flags_rev, _block(esc_flags, g, kt), _block(sym, g, kt), kt)
    # one gather: [stream | escape segment | n_words, n_esc as 4 int16 words]
    counts = torch.cat([n_words, n_esc])
    tail = torch.stack([counts & 0xFFFF, counts >> 16], dim=1).reshape(-1)
    rows = torch.stack(all_gather(torch.cat([stream[0], esc[0], rans_cuda.to_i16(tail)]), pg))
    words = rows[:, -4:].to(torch.int64) & 0xFFFF
    n = stream.shape[1]
    return (rows[:, :n], words[:, 0] | (words[:, 1] << 16), rows[:, n:-4],
            words[:, 2] | (words[:, 3] << 16))


def sharded_decode_stage(dec: DecoderState, streams, escs, indexes, keep, t: DeviceTables,
                         lanes: int, mesh, axis: str = "model", rows=None):
    """Decode one stage, rank g advancing its own sub-stream.

    dec: every group's state (states (K,), offsets (G,), esc_offsets (G,));
    streams (G, W) and escs (G, E) int16, every group's; indexes, keep
    (n,); `rows` the stage's CDF rows (`rans_device.decode_stage_scan`).
    Returns (dec', values (n,) int32 in global symbol order), on every
    rank."""
    groups, kt, g, pg = _group(mesh, axis, lanes)
    n = indexes.shape[0]
    ib = _block(rans_device._pad_to_grid(indexes.to(I32), lanes), g, kt)
    kb = _block(rans_device._pad_to_grid(keep.to(torch.uint8), lanes), g, kt)
    mine = DecoderState(dec.states[g * kt : (g + 1) * kt].contiguous(),
                        dec.offsets[g : g + 1].contiguous(), dec.esc_offsets[g : g + 1])
    states, offset, cums = rans_device.decode_stage_scan(
        mine, streams[g : g + 1].contiguous(), ib, kb, t, kt, rows)
    esc_offset, vals = rans_device.decode_stage_values(
        mine.esc_offsets, cums, escs[g : g + 1], ib.reshape(-1), kb.reshape(-1), t, kt)
    # one gather: [states (kt) | offset | esc offset | values (P*kt)]
    out = torch.stack(all_gather(torch.cat([states, offset, esc_offset, vals]), pg))
    p = ib.shape[0]
    return (
        DecoderState(out[:, :kt].reshape(-1), out[:, kt], out[:, kt + 1]),
        out[:, kt + 2 :].reshape(groups, p, kt).transpose(0, 1).reshape(-1)[:n],
    )
