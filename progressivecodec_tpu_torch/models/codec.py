"""Codec base: entropy tables and container serialization.

Counterpart of `progressivecodec_tpu/models/codec.py`.  `update()` builds
the CDF tables on the host from the model's bottleneck parameters, once
per codec; the codec holds the live model, so after the weights change
`update(force=True)` rebuilds them.  The container keeps the PCT2 layout but carries the port's own
magic: sigma bits depend on the implementation, so a stream made by the
JAX package is not expected to decode here and is refused at deserialize
instead of desyncing.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from progressivecodec_tpu_torch.coder.rans_device import DeviceTables
from progressivecodec_tpu_torch.coder.tables import (
    DEFAULT_LANES, MAX_LANES, PRECISION, check_groups, check_lanes, merge_tables,
)
from progressivecodec_tpu_torch.config import ModelConfig
from progressivecodec_tpu_torch.entropy.bottleneck import build_bottleneck_tables
from progressivecodec_tpu_torch.entropy.gaussian import build_gaussian_tables
from progressivecodec_tpu_torch.utils.profiling import span

# The JAX package writes b"PCT2".  Bump MAGIC on an incompatible header
# change and FORMAT_VERSION on any change that could alter sigma bits.
MAGIC = b"PTC2"
FORMAT_VERSION = 1


def words_np(x) -> np.ndarray:
    """Stream words (int16-bit-pattern tensor or uint16 array) -> np.uint16."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().view(np.uint16)
    return np.asarray(x, dtype=np.uint16)


class Codec:
    """Model + coder tables + container format."""

    def __init__(self, model, lanes: int = DEFAULT_LANES, groups: int = 1):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.groups = check_groups(groups)
        self.lanes = check_lanes(lanes, self.groups)
        self._tables = None
        self._device_tables = None
        self._gauss_row0 = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def update(self, force: bool = False):
        """Build the merged CDF tables (bottleneck rows, then Gaussian rows):
        once, or again with `force`.  The codec holds the live model, so
        after its weights change, call this with `force` or build a new
        codec."""
        if self._tables is not None and not force:
            return self._tables
        bt = build_bottleneck_tables(self.model.entropy_bottleneck.host_params(), PRECISION)
        gt = build_gaussian_tables(self.cfg.scale_table.values(), precision=PRECISION)
        merged, starts = merge_tables(bt, gt)
        merged.inverse()
        self._tables = merged
        self._gauss_row0 = starts[1]
        self._device_tables = DeviceTables.from_tables(merged, self.device)
        return merged

    @property
    def device_tables(self) -> DeviceTables:
        if self._device_tables is None:
            self.update()
        return self._device_tables

    @property
    def gauss_row0(self) -> int:
        if self._gauss_row0 is None:
            self.update()
        return self._gauss_row0

    @torch.no_grad()
    def forward_single_quality(self, x, quality: float, mask_pol: str | None = None) -> dict:
        """The model's eval forward at one quality, with its likelihoods, on
        x (B, H, W, 3) in [0, 1] (see the model's `forward_single_quality`)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self.model.forward_single_quality(x, float(quality), mask_pol)

    @span("codec:serialize")
    def serialize(self, data: dict) -> bytes:
        """Container: magic | version u8 | quality f32 | batch u16 | z_h u16 |
        z_w u16 | lanes u16 | groups u8 | mask_pol len u8 + utf8 | per group
        (n_words u32 | n_esc_words u32 | words | escape words).  The dict
        holds G `streams` and G `escs` for every G, one stream being G = 1."""
        mp = (data["mask_pol"] or self.cfg.mask_policy).encode()
        groups = len(data["streams"])
        lanes = data.get("lanes", self.lanes)
        if int(lanes) != lanes or not 0 <= lanes <= MAX_LANES:
            raise ValueError(f"lanes {lanes!r} do not fit the container's u16")
        head = MAGIC + struct.pack(
            "<BfHHHHBB", FORMAT_VERSION, data["quality"], data["batch"],
            *data["z_shape"], int(lanes), groups, len(mp),
        )
        body = b""
        for words, esc in zip(data["streams"], data["escs"]):
            with span("sync:words_to_host"):
                words, esc = words_np(words).astype("<u2"), words_np(esc).astype("<u2")
            with span("glue:pack"):
                body += struct.pack("<II", len(words), len(esc)) + words.tobytes() + esc.tobytes()
        with span("glue:pack"):
            return head + mp + body

    @span("codec:deserialize")
    @span("glue:parse")
    def deserialize(self, blob: bytes) -> dict:
        if blob[:4] != MAGIC:
            raise ValueError(
                f"bad container magic {blob[:4]!r}, want {MAGIC!r}: streams from "
                "another implementation (e.g. the JAX package's b'PCT2') do not "
                "decode here, because sigma bits depend on the implementation"
            )
        ver, quality, batch, zh, zw, lanes, groups, mlen = struct.unpack(
            "<BfHHHHBB", blob[4:19]
        )
        if ver != FORMAT_VERSION:
            raise ValueError(f"container format v{ver} != this build's v{FORMAT_VERSION}")
        check_lanes(lanes, check_groups(groups))
        mp = blob[19 : 19 + mlen].decode()
        off = 19 + mlen
        streams, escs = [], []
        for _ in range(groups):
            if off + 8 > len(blob):
                raise ValueError(f"container is {len(blob)} bytes, cut inside a segment header")
            n_words, n_esc = struct.unpack("<II", blob[off : off + 8])
            off += 8
            streams.append(np.frombuffer(blob[off : off + 2 * n_words], dtype="<u2"))
            off += 2 * n_words
            escs.append(np.frombuffer(blob[off : off + 2 * n_esc], dtype="<u2"))
            off += 2 * n_esc
        if off != len(blob):
            raise ValueError(f"container is {len(blob)} bytes, its header says {off}")
        return {"z_shape": (zh, zw), "batch": batch, "quality": quality, "mask_pol": mp,
                "lanes": lanes, "groups": groups, "streams": streams, "escs": escs}


def _stream_capacity(batch: int, z_shape: tuple, cfg: ModelConfig, lanes: int) -> int:
    """Upper bound on words: header + one word per (padded) symbol."""
    hz, wz = z_shape
    hy, wy = hz * 4, wz * 4
    n_z = batch * hz * wz * cfg.N
    n_slices = cfg.M // cfg.dim_chunk
    padded = 0
    for n in [n_z] + [batch * hy * wy * cfg.dim_chunk] * n_slices:
        padded += -(-n // lanes) * lanes
    return 2 * lanes + padded
