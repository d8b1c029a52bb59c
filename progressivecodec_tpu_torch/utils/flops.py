"""FLOP accounting and MFU for the card.

Counterpart of `progressivecodec_tpu/utils/flops.py`.  `count_flops` runs
the function once under `torch.utils.flop_counter.FlopCounterMode` and
counts convolutions and matrix products (the work JAX counts as
`conv_general_dilated` and `dot_general`); elementwise work is left out,
as in JAX.

One deliberate difference: JAX computes a transposed convolution as a
convolution of the input dilated by the stride, and counts the inserted
zeros, s^2 times the multiply-adds the transposed convolution does.  The
port counts the real work, FlopCounterMode's own rule for a transposed
convolution.  `flops_by_kind` gives the split.

`chip_peak_flops` is the float32 rate with TF32 off, since the codec runs
that way (`device.set_deterministic`); an unknown card raises.
"""

from __future__ import annotations

import torch
from torch.utils import flop_counter

aten = torch.ops.aten
_CONV_OPS = (aten.convolution, aten._convolution, aten.cudnn_convolution,
             aten._slow_conv2d_forward, aten.convolution_overrideable)

# float32 (no tensor cores) dense peaks, NVIDIA H100 data sheet
_PEAKS = (
    (("H100", "PCIe"), 51.2e12, "H100 PCIe: 51.2 TFLOP/s float32 (TF32 off)"),
    (("H100", "HBM3"), 66.9e12, "H100 SXM: 66.9 TFLOP/s float32 (TF32 off)"),
    (("H100", "SXM"), 66.9e12, "H100 SXM: 66.9 TFLOP/s float32 (TF32 off)"),
)


def flops_by_kind(fn, *args, **kwargs) -> dict:
    """FLOPs of one call of fn(*args, **kwargs): {"conv", "conv_transpose",
    "matmul"}, the last holding every product FlopCounterMode counts that
    is not a convolution."""
    kinds = {"conv": 0, "conv_transpose": 0}

    def conv(x_shape, w_shape, bias, stride, padding, dilation, transposed, *args, out_shape=None,
             **kwargs):
        n = flop_counter.conv_flop_count(x_shape, w_shape, out_shape, transposed=bool(transposed))
        kinds["conv_transpose" if transposed else "conv"] += n
        return n

    with flop_counter.FlopCounterMode(display=False, custom_mapping={op: conv for op in _CONV_OPS}) as m:
        fn(*args, **kwargs)
    kinds["matmul"] = m.get_total_flops() - kinds["conv"] - kinds["conv_transpose"]
    return kinds


def count_flops(fn, *args, **kwargs) -> int:
    """Convolution and matrix-product FLOPs of one call of fn."""
    return sum(flops_by_kind(fn, *args, **kwargs).values())


def chip_peak_flops(device=None) -> tuple[float, str]:
    """(float32 FLOP/s, note) of the attached card; raises for a card the
    table does not hold."""
    name = torch.cuda.get_device_name(device)
    for keys, peak, note in _PEAKS:
        if all(k in name for k in keys):
            return peak, note
    raise ValueError(f"no float32 peak known for {name!r}")


def mfu(flops: int, seconds: float, device=None) -> float:
    peak, _ = chip_peak_flops(device)
    return flops / (seconds * peak)
