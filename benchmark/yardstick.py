"""The benchmark's own arithmetic: the card's peaks, the FLOPs of a round
trip counted on the configuration's plain reference, and the bytes and
operations of the rANS scans over the stages that reference codes.

Frozen here so that the program cannot move them:
  * the float32 peak by card name from `progressivecodec_tpu_torch/utils/flops.py`
    (`chip_peak_flops`, NVIDIA's H100 data sheet, TF32 off);
  * the scans' bytes and INT32 operations from `chip_smoke.py`
    (`MEM_BYTES_PER_S`, `INT32_OPS_PER_S`, the encode count of
    `check_kernels` and `decode_bound`): each input read once and each
    output written once at 3.35 TB/s, ~30 (encode) and ~12 (decode)
    operations per cell at 33.5 TOP/s;
  * the MFU gate of `progressivecodec_tpu_torch/bench.py` (`gated_mfu`): a
    share of the peak at or above 1 means the timing missed work, and raises.
"""

from __future__ import annotations

import sys

import numpy as np
from torch.utils import flop_counter

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
ENCODE_OPS_PER_CELL = 30
DECODE_OPS_PER_CELL = 12
_PEAKS = ((("H100", "PCIe"), 51.2e12), (("H100", "HBM3"), 66.9e12), (("H100", "SXM"), 66.9e12))


def peak_flops(name: str) -> float:
    """float32 FLOP/s (TF32 off) of the card called `name`."""
    for keys, peak in _PEAKS:
        if all(k in name for k in keys):
            return peak
    raise ValueError(f"no float32 peak known for {name!r}")


def gated_share(flops: float, seconds: float, peak: float) -> float:
    share = flops / (seconds * peak)
    if not share < 1.0:
        raise AssertionError(f"impossible measurement: {flops:.4g} FLOP in {seconds:.4g} s is "
                             f"{share:.3f} of the {peak:.4g} FLOP/s peak; the timing missed work")
    return share


def _count(fn) -> int:
    with flop_counter.FlopCounterMode(display=False) as m:
        fn()
    return int(m.get_total_flops())


def reference_of(cfg):
    """The reference module whose `Cfg` made `cfg`: the harness registers the
    one it loads for a run, and the metric readers hand over only `cfg`."""
    return sys.modules[type(cfg).__module__]


def chain_flops(cfg, batch: int, h: int, w: int, quality: float) -> int:
    """FLOPs one request needs, as the configuration's reference counts them."""
    return reference_of(cfg).chain_flops(cfg, batch, h, w, quality)


def scan_work(cfg, cdf_length: np.ndarray, batch: int, h: int, w: int, quality: float,
              lanes: int, payload_words: int) -> dict:
    """Bytes and INT32 operations of one request's encode scan and decode
    scans, over the stages the configuration's reference codes."""
    sizes = reference_of(cfg).stage_sizes(cfg, batch, h, w, quality)
    cells = [-(-n // lanes) * lanes for n in sizes]
    z_table = 2 * int(cdf_length[: cfg.N].sum())
    g_table = 2 * int(cdf_length[cfg.N :].sum())
    enc_bytes = sum(cells) * (4 + 1 + 2 + 1) + 4 * lanes
    dec_bytes = (sum(cells) * (4 + 1 + 4) + z_table + g_table * (len(sizes) - 1)
                 + 2 * payload_words + len(sizes) * (8 * lanes + 8))
    return {"encode_bytes": enc_bytes, "encode_ops": ENCODE_OPS_PER_CELL * sum(cells),
            "decode_bytes": dec_bytes, "decode_ops": DECODE_OPS_PER_CELL * sum(cells)}


def bound_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S)
