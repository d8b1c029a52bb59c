"""CDF table bundling for the PCT1 interleaved-rANS stream format.

A copy of `progressivecodec_tpu/coder/tables.py`.

=== PCT1 wire format (designed for vectorized on-device coding) ===

A K-lane interleaved stream that encodes and decodes as pure SIMD ops:

  * 32-bit lane state, L = 2^16, 16-bit renormalization words,
    16-bit probability precision (same precision as the reference).
  * Symbol i of a stage maps to lane (i mod K) at position (i div K).
  * Encoder walks positions in reverse; decoder walks forward.  The usual
    interleaved-rANS mirror property makes the renorm-word order identical,
    so all lanes share ONE word stream (no per-lane streams).
  * Stream layout (little-endian uint16 words):
      words[0 : 2K]  lane initial decode states (lane j = w[2j] | w[2j+1]<<16)
      words[2K : ]   payload, in decode order (position-major, lane-minor)
  * A container may hold multiple *stages* (z, then each y slice group);
    stages are decoded sequentially from the same running word stream so
    later stages' CDF indexes may depend on earlier decoded stages.
  * Masked-out elements are *skipped* (consume zero bits) — unlike the
    reference, which spends ~0.05 bits each coding zeros for them
    (CHProg_cnn.py:828-830).
  * Out-of-support symbols are coded LOSSLESSLY via the escape extension
    (reference semantics: 4-bit bypass escapes, rans_interface.cpp:99-164;
    redesigned here for SIMD lanes): the row's sentinel index
    (max_symbol + 1 — the tail-mass entry, frequency >= 1 by the CDF
    builder's strict-monotonicity invariant) is coded in the rANS stream,
    and the exact int32 value is appended to the *escape segment* as a
    fixed-width (lo16, hi16) uint16 pair.  The escape segment follows the
    payload; escape pairs appear in decode order (stage-major,
    position-major, lane-minor).  The segment boundary (esc_start) is
    carried in the container header.  Fixed-width raw values keep both
    encode-side extraction and decode-side substitution fully vectorized
    (a cumsum compaction outside the rANS scan).  All three
    implementations (JAX device, C++ host, numpy golden) are
    bit-identical, including escapes.

Integrity invariant: after decoding every stage, each lane state must be
exactly L, the payload pointer must sit exactly at esc_start, and the
escape segment must be fully consumed — "stream_ok".
"""

from __future__ import annotations

import dataclasses

import numpy as np

PRECISION = 16
RANS_L = 1 << 16
WORD_BITS = 16
DEFAULT_LANES = 512
# A container holds the lane count in 16 bits and the group count in 8.
MAX_GROUPS, MAX_LANES = 255, 0xFFFF


def check_groups(groups) -> int:
    """Raise ValueError unless `groups` is an integer in [1, 255]."""
    if int(groups) != groups or not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups must be an integer in [1, {MAX_GROUPS}], got {groups!r}")
    return int(groups)


def check_lanes(lanes, groups: int = 1) -> int:
    """Raise ValueError unless `lanes` suits `groups` streams: an integer in
    [1, 65535] (the container's u16), and with G > 1 (PCT1-G) a multiple of
    G.  These are the lane counts the JAX codec takes; the decode kernel
    spreads a stream or group wider than one CTA over several
    (`rans_cuda.decode_span`)."""
    if int(lanes) != lanes or not 1 <= lanes <= MAX_LANES or lanes % groups:
        raise ValueError(
            f"lanes must be an integer in [1, {MAX_LANES}] and a multiple of groups={groups}, "
            f"got {lanes!r}"
        )
    return int(lanes)


@dataclasses.dataclass
class CoderTables:
    """Padded CDF matrix + per-row metadata, plus the decode inverse table.

    cdf: (R, Lmax) int32, row r valid through cdf_length[r].
    offset: (R,) int32 — symbol value = coded index + offset.
    inv: (R, 2^16) int32 — symbol index from cumulative frequency
         (built lazily; ~R*256KB, lives in HBM for device decode).
    """

    cdf: np.ndarray
    cdf_length: np.ndarray
    offset: np.ndarray
    _inv: np.ndarray | None = None

    @property
    def max_symbol(self) -> np.ndarray:
        """Highest encodable symbol index per row (inclusive): pmf_length-1.

        Row r has cdf_length[r] entries; entry count - 2 is the escape/tail
        sentinel in the reference; we clamp to one below it.
        """
        return self.cdf_length - 3

    def inverse(self) -> np.ndarray:
        if self._inv is None:
            r, _ = self.cdf.shape
            inv = np.zeros((r, 1 << PRECISION), dtype=np.int32)
            for i in range(r):
                n = int(self.cdf_length[i]) - 1  # number of symbols incl. tail
                row = self.cdf[i, : n + 1].astype(np.int64)
                # symbol s occupies cum range [cdf[s], cdf[s+1])
                widths = np.diff(row)
                inv[i] = np.repeat(np.arange(n, dtype=np.int32), widths)
            self._inv = inv
        return self._inv


def merge_tables(*tables: dict) -> tuple[CoderTables, list[int]]:
    """Stack several {"cdf","cdf_length","offset"} dicts into one
    CoderTables; returns (merged, row_offsets) so stage indexes can be
    shifted into the unified row space."""
    lmax = max(t["cdf"].shape[1] for t in tables)
    rows, lengths, offsets, starts = [], [], [], []
    acc = 0
    for t in tables:
        r, l = t["cdf"].shape
        pad = np.zeros((r, lmax), dtype=np.int32)
        pad[:, :l] = t["cdf"]
        rows.append(pad)
        lengths.append(np.asarray(t["cdf_length"], dtype=np.int32))
        offsets.append(np.asarray(t["offset"], dtype=np.int32))
        starts.append(acc)
        acc += r
    return (
        CoderTables(
            cdf=np.concatenate(rows, axis=0),
            cdf_length=np.concatenate(lengths),
            offset=np.concatenate(offsets),
        ),
        starts,
    )
