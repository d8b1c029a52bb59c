"""NumPy reference of the entropy coder and the container.

Frozen copies, so that a change to the program cannot move the yardstick:
  * the CDF tables: `progressivecodec_tpu_torch/entropy/cdf.py`
    (`pmf_to_quantized_cdf`), `entropy/bottleneck.py`
    (`build_bottleneck_tables`) and `entropy/gaussian.py`
    (`build_gaussian_tables`), which follow CompressAI's
    `EntropyModel._pmf_to_cdf`;
  * the PCT1 interleaved rANS coder: `progressivecodec_tpu/coder/rans_numpy.py`
    (`encode_stages`, `StreamDecoder.decode_stage`), the golden host coder
    the program's tests hold its kernels to;
  * the container layout: `progressivecodec_tpu_torch/models/codec.py`
    (`serialize`).

Everything here is computed from the weights the benchmark drew, never from
tables the program built.
"""

from __future__ import annotations

import struct

import numpy as np
import scipy.special
import scipy.stats

PRECISION = 16
RANS_L = 1 << 16
_MASK16 = (1 << 16) - 1
HEADER_BYTES = 4 + struct.calcsize("<BfHHHHBB")  # magic, then the fixed fields


# ---------------------------------------------------------------------------
# CDF tables
# ---------------------------------------------------------------------------


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    pmf = np.asarray(pmf, dtype=np.float64)
    one = 1 << precision
    freq = np.zeros(len(pmf) + 1, dtype=np.uint64)
    scaled = np.round(pmf.astype(np.float32).astype(np.float64) * one)
    scaled = np.where(np.isfinite(scaled), np.maximum(scaled, 0.0), 0.0)
    freq[1:] = scaled.astype(np.uint64)
    total = int(freq.sum())
    if total == 0:
        raise ValueError("pmf sums to zero after quantization")
    freq = (int(one) * freq) // total
    cdf = np.cumsum(freq, dtype=np.uint64)
    cdf[-1] = one
    cdf = cdf.astype(np.int64)
    for i in range(len(cdf) - 1):
        if cdf[i] == cdf[i + 1]:
            widths = cdf[1:] - cdf[:-1]
            cand = np.where(widths > 1)[0]
            if len(cand) == 0:
                raise ValueError("cannot repair zero-width cdf entry")
            steal = cand[np.argmin(widths[cand])]
            if steal < i:
                cdf[steal + 1 : i + 1] -= 1
            else:
                cdf[i + 1 : steal + 1] += 1
    return cdf.astype(np.int32)


def _cdf_rows(pmf, tail, pmf_length, max_length):
    out = np.zeros((pmf.shape[0], max_length + 2), dtype=np.int32)
    for r in range(pmf.shape[0]):
        n = int(pmf_length[r])
        cdf = pmf_to_quantized_cdf(np.concatenate([pmf[r, :n], [tail[r]]]))
        out[r, : len(cdf)] = cdf
    return out


def bottleneck_tables(eb: dict) -> dict:
    """eb: numpy "_matrix{i}", "_bias{i}", "_factor{i}", "quantiles" -> rows."""
    q = eb["quantiles"]
    med = q[:, 0, 1]
    minima = np.clip(np.ceil(med - q[:, 0, 0]).astype(np.int32), 0, None)
    maxima = np.clip(np.ceil(q[:, 0, 2] - med).astype(np.int32), 0, None)
    pmf_start = med - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    samples = np.arange(max_length)[None, :] + pmf_start[:, None]
    c = samples.shape[0]

    def logits(v):
        x = v.astype(np.float32)
        for i in range(5):
            x = np.einsum("cij,cjn->cin", np.logaddexp(0.0, eb[f"_matrix{i}"].astype(np.float32)), x)
            x = x + eb[f"_bias{i}"].astype(np.float32)
            if i < 4:
                x = x + np.tanh(eb[f"_factor{i}"].astype(np.float32)) * np.tanh(x)
        return x

    vals = samples.reshape(c, 1, -1)
    lower, upper = logits(vals - 0.5), logits(vals + 0.5)
    sign = -np.sign(lower + upper)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    pmf = np.abs(sig(sign * upper) - sig(sign * lower))[:, 0, :]
    tail = (sig(lower[:, 0, :1]) + sig(-upper[:, 0, -1:]))[:, 0]
    return {"cdf": _cdf_rows(pmf, tail, pmf_length, max_length),
            "cdf_length": (pmf_length + 2).astype(np.int32), "offset": (-minima).astype(np.int32)}


def gaussian_tables(scale_table: np.ndarray, tail_mass: float = 1e-9) -> dict:
    scale_table = np.asarray(scale_table, dtype=np.float64)
    mult = -scipy.stats.norm.ppf(tail_mass / 2)
    center = np.ceil(scale_table * mult).astype(np.int32)
    pmf_length = 2 * center + 1
    max_length = int(pmf_length.max())
    samples = np.abs(np.arange(max_length, dtype=np.int32) - center[:, None]).astype(np.float32)
    s = scale_table.astype(np.float32)[:, None]
    cum = lambda v: 0.5 * scipy.special.erfc(-(2**-0.5) * v)  # noqa: E731
    upper, lower = cum((0.5 - samples) / s), cum((-0.5 - samples) / s)
    return {"cdf": _cdf_rows(upper - lower, 2 * lower[:, 0], pmf_length, max_length),
            "cdf_length": (pmf_length + 2).astype(np.int32), "offset": (-center).astype(np.int32)}


class Tables:
    """The merged table: the bottleneck's rows, then the Gaussian rows."""

    def __init__(self, eb: dict, scale_table: np.ndarray):
        parts = [bottleneck_tables(eb), gaussian_tables(scale_table)]
        lmax = max(t["cdf"].shape[1] for t in parts)
        self.cdf = np.concatenate([np.pad(t["cdf"], ((0, 0), (0, lmax - t["cdf"].shape[1])))
                                   for t in parts])
        self.cdf_length = np.concatenate([t["cdf_length"] for t in parts])
        self.offset = np.concatenate([t["offset"] for t in parts])
        self.max_symbol = self.cdf_length - 3
        self._inv: dict = {}

    def inverse_rows(self, rows) -> dict:
        """{row: symbol index by cumulative frequency} for the given rows."""
        for r in rows:
            if r not in self._inv:
                n = int(self.cdf_length[r]) - 1
                widths = np.diff(self.cdf[r, : n + 1].astype(np.int64))
                self._inv[r] = np.repeat(np.arange(n, dtype=np.int32), widths)
        return self._inv


# ---------------------------------------------------------------------------
# the PCT1 coder
# ---------------------------------------------------------------------------


def _split_escapes(sym, idx, keep, t: Tables):
    v = sym.astype(np.int64) - t.offset[idx]
    maxs = t.max_symbol[idx]
    in_sup = (v >= 0) & (v <= maxs)
    return np.where(in_sup, v, maxs + 1).astype(np.int64), keep & ~in_sup


def encode(stages, t: Tables, lanes: int):
    """stages [(symbols, rows, keep)] in decode order -> (stream words,
    escape words), as the container stores them."""
    states = np.full(lanes, RANS_L, dtype=np.uint64)
    payload_rev, esc_words = [], []
    for sym, idx, keep in stages:
        _, esc = _split_escapes(sym, idx, keep, t)
        raw = sym.astype(np.int64)[esc].astype(np.uint32)
        pair = np.empty(2 * raw.size, np.uint16)
        pair[0::2] = (raw & _MASK16).astype(np.uint16)
        pair[1::2] = (raw >> 16).astype(np.uint16)
        esc_words.append(pair)
    for sym, idx, keep in reversed(stages):
        n = len(sym)
        p = -(-n // lanes)
        pad = p * lanes - n
        v, _ = _split_escapes(sym, idx, keep, t)
        v = np.concatenate([v, np.zeros(pad, np.int64)]).reshape(p, lanes)
        ix = np.concatenate([idx.astype(np.int64), np.zeros(pad, np.int64)]).reshape(p, lanes)
        kp = np.concatenate([keep, np.zeros(pad, bool)]).reshape(p, lanes)
        start_all = t.cdf[ix, v].astype(np.uint64)
        freq_all = (t.cdf[ix, v + 1] - t.cdf[ix, v]).astype(np.uint64)
        for step in range(p - 1, -1, -1):
            ki = kp[step]
            freq = np.where(ki, freq_all[step], 1)
            flag = ki & (states >= (freq << 16))
            words = (states & _MASK16).astype(np.uint16)
            states = np.where(flag, states >> 16, states)
            q, r = np.divmod(states, freq)
            states = np.where(ki, (q << 16) + r + start_all[step], states)
            if flag.any():
                payload_rev.append(words[flag])
    payload = np.concatenate(payload_rev[::-1]) if payload_rev else np.zeros(0, np.uint16)
    head = np.zeros(2 * lanes, dtype=np.uint16)
    head[0::2] = (states & _MASK16).astype(np.uint16)
    head[1::2] = ((states >> 16) & _MASK16).astype(np.uint16)
    return np.concatenate([head, payload]), np.concatenate(esc_words)


def container_bytes(stream_words: int, esc_words: int, mask_pol: str) -> int:
    """Bytes of a one-stream container holding that many words."""
    return HEADER_BYTES + len(mask_pol.encode()) + 8 + 2 * (stream_words + esc_words)


def parse_container(blob: bytes) -> dict:
    """The one-stream container's header and words (the layout of the
    program's `Codec.serialize`)."""
    _, quality, batch, zh, zw, lanes, groups, mlen = struct.unpack("<BfHHHHBB", blob[4:HEADER_BYTES])
    off = HEADER_BYTES + mlen
    if groups != 1:
        raise ValueError(f"the reference reads one-stream containers, not groups={groups}")
    n_words, n_esc = struct.unpack("<II", blob[off : off + 8])
    off += 8
    words = np.frombuffer(blob[off : off + 2 * n_words], dtype="<u2").astype(np.uint16)
    esc = np.frombuffer(blob[off + 2 * n_words : off + 2 * (n_words + n_esc)], dtype="<u2")
    return {"quality": quality, "batch": batch, "z_shape": (zh, zw), "lanes": lanes,
            "words": words, "esc": esc.astype(np.uint16)}


def decode_first_stage(words, esc, rows, keep, t: Tables, lanes: int) -> np.ndarray:
    """The values of the stream's first stage (z), read with the reference's
    tables and rows."""
    head = words[: 2 * lanes].astype(np.uint64)
    states = head[0::2] | (head[1::2] << 16)
    offset = 2 * lanes
    inv = t.inverse_rows(np.unique(rows).tolist())
    n = len(rows)
    p = -(-n // lanes)
    pad = p * lanes - n
    ix = np.concatenate([rows.astype(np.int64), np.zeros(pad, np.int64)]).reshape(p, lanes)
    kp = np.concatenate([keep, np.zeros(pad, bool)]).reshape(p, lanes)
    out = np.zeros((p, lanes), dtype=np.int64)
    inv_t = np.zeros((t.cdf.shape[0], 1 << PRECISION), dtype=np.int32)
    for r, a in inv.items():
        inv_t[r] = a
    for step in range(p):
        ii, ki = ix[step], kp[step]
        cum = (states & _MASK16).astype(np.int64)
        s = inv_t[ii, cum]
        start = t.cdf[ii, s].astype(np.uint64)
        freq = (t.cdf[ii, s + 1] - t.cdf[ii, s]).astype(np.uint64)
        adv = freq * (states >> 16) + cum.astype(np.uint64) - start
        flag = ki & (adv < RANS_L)
        nread = int(flag.sum())
        if nread:
            pos = offset + np.cumsum(flag) - 1
            w = words[np.where(flag, pos, 0).clip(0, len(words) - 1)].astype(np.uint64)
            adv = np.where(flag, (adv << 16) | w, adv)
            offset += nread
        states = np.where(ki, adv, states)
        out[step] = np.where(ki, s + t.offset[ii], 0)
    vals = out.reshape(-1)[:n]
    sentinel = t.offset[rows] + t.max_symbol[rows] + 1
    is_esc = keep & (vals == sentinel)
    if is_esc.any():
        j = 2 * (np.cumsum(is_esc) - 1)
        lo = esc[np.where(is_esc, j, 0).clip(0, max(len(esc) - 1, 0))].astype(np.uint32) if len(esc) else 0
        hi = esc[np.where(is_esc, j + 1, 0).clip(0, max(len(esc) - 1, 0))].astype(np.uint32) if len(esc) else 0
        vals = np.where(is_esc, (lo | (hi << 16)).astype(np.int32), vals)
    return vals


def container_blob(words, esc, batch: int, z_shape, lanes: int, quality: float, mask_pol: str) -> bytes:
    """A one-stream container holding these words (the program's layout)."""
    mp = mask_pol.encode()
    head = b"PTC2" + struct.pack("<BfHHHHBB", 1, quality, batch, *z_shape, lanes, 1, len(mp))
    return (head + mp + struct.pack("<II", len(words), len(esc))
            + np.asarray(words, "<u2").tobytes() + np.asarray(esc, "<u2").tobytes())
