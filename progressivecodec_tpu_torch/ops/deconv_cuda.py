"""g_s's transposed convolution on the card (csrc/deconv.cu).

ConvTranspose2d with kernel 5, stride 2, padding 2 and output_padding 1,
float32, NCHW, by the sub-pixel split: output pixel (2i+a, 2j+b) gathers
input (i+dy, j+dx) through tap (a+2-2dy, b+2-2dx) for the taps that exist,
so the four output phases are four stride-1 convolutions of 3x3, 3x2, 2x3
and 2x2 taps.  It replaces no Pallas kernel: the JAX package leaves its
transposed convolutions to XLA.  `ops/conv.deconv2d` launches it for a
CUDA tensor with autograd off; the CPU and autograd keep
`F.conv_transpose2d`, since the kernel has no backward.

  subpixel_taps      the phase/tap table the kernel unrolls
  pack_weight        IOHW weights -> (Cin, 25, Cout_p), the kernel's layout
  deconv2d_subpixel  the plain version: four stride-1 `F.conv2d` from the
                     table and the packed weights
  plan               the kernel instance for a shape
  deconv2d_s2k5      the wrapper: checks, packs the weights, launches on the
                     current stream, counts `launch:deconv2d`

The weights are packed on every call (at most 6.1 MB, g_s's first layer),
so no cache has to follow `load_state_dict`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from progressivecodec_tpu_torch import build
from progressivecodec_tpu_torch.utils.profiling import count

KERNEL = 5
STRIDE = 2
_VP = ctypes.c_void_p


class Instance(NamedTuple):
    index: int  # the kernel's instance number (csrc/deconv.cu: deconv_s2k5)
    rows: int  # input rows of a CTA's tile
    cols: int  # input columns of a CTA's tile
    cot: int  # packed output channels of a CTA


# Mirrors the instances of csrc/deconv.cu's deconv_s2k5.
INSTANCES = {
    "wide": Instance(0, 8, 8, 32),
    "narrow": Instance(1, 32, 16, 4),
}


def subpixel_taps() -> dict:
    """{(a, b): ((dy, dx, ky, kx), ...)}: output phase (a, b) sums input
    (i+dy, j+dx) times tap (ky, kx), in the kernel's order (dy, then dx,
    ascending).  3x3, 3x2, 2x3 and 2x2 taps: each of the 25 once."""
    def axis(a):
        return [(d, a + 2 - 2 * d) for d in (-1, 0, 1) if 0 <= a + 2 - 2 * d < KERNEL]

    return {(a, b): tuple((dy, dx, ky, kx) for dy, ky in axis(a) for dx, kx in axis(b))
            for a in (0, 1) for b in (0, 1)}


def pack_weight(w: torch.Tensor, coutp: int) -> torch.Tensor:
    """IOHW (Cin, Cout, 5, 5) -> (Cin, 25, coutp), tap ky*5+kx, output
    channels contiguous and zero past Cout."""
    cin, cout = w.shape[:2]
    wp = w.permute(0, 2, 3, 1).reshape(cin, KERNEL * KERNEL, cout)
    if coutp > cout:
        wp = F.pad(wp, (0, coutp - cout))
    return wp.contiguous()


def deconv2d_subpixel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: each output phase a stride-1 `F.conv2d` of the
    one-pixel-padded input with the taps `subpixel_taps` gives it, taken
    from `pack_weight`'s layout.  x (B, Cin, H, W) -> (B, Cout, 2H, 2W)."""
    bsz, cin, h, wd = x.shape
    cout = w.shape[1]
    wp = pack_weight(w, cout)
    xp = F.pad(x, (1, 1, 1, 1))
    y = x.new_empty((bsz, cout, STRIDE * h, STRIDE * wd))
    for (a, bp), taps in subpixel_taps().items():
        dy0, dx0 = min(t[0] for t in taps), min(t[1] for t in taps)
        ny, nx = 1 + max(t[0] for t in taps) - dy0, 1 + max(t[1] for t in taps) - dx0
        kern = x.new_zeros((cout, cin, ny, nx))
        for dy, dx, ky, kx in taps:
            kern[:, :, dy - dy0, dx - dx0] = wp[:, ky * KERNEL + kx, :].T
        xs = xp[:, :, 1 + dy0 : 1 + dy0 + h + ny - 1, 1 + dx0 : 1 + dx0 + wd + nx - 1]
        y[:, :, a::2, bp::2] = F.conv2d(xs, kern)
    if b is not None:
        y += b[:, None, None]
    return y


def plan(cout: int) -> str:
    """The instance for `cout` output channels: "narrow" for at most 3 (g_s's
    last layer), "wide" otherwise; Cout is padded to the instance's tile."""
    return "narrow" if cout <= 3 else "wide"


def grid_ctas(name: str, batch: int, cout: int, h: int, w: int) -> int:
    """CTAs of one launch."""
    inst = INSTANCES[name]
    return batch * -(-h // inst.rows) * -(-w // inst.cols) * -(-cout // inst.cot)


def macs(batch: int, cin: int, cout: int, h: int, w: int) -> int:
    """Multiply-adds of one call: 25 per input position, Cin and Cout."""
    return batch * h * w * cin * cout * KERNEL * KERNEL


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.library("deconv").deconv_s2k5
    f.argtypes = [ctypes.c_int, _VP, _VP, _VP, _VP] + [ctypes.c_int] * 6 + [_VP]
    f.restype = ctypes.c_int
    return f


def _check(name, t, ndim, device):
    if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-D float32 tensor, got {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")


def deconv2d_s2k5(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                  stride: int = STRIDE) -> torch.Tensor:
    """The kernel: x (B, Cin, H, W), w (Cin, Cout, 5, 5), b (Cout,) or None
    -> (B, Cout, 2H, 2W), float32 CUDA tensors.  Raises for any other
    geometry."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"deconv2d_s2k5: the kernel runs on CUDA tensors, got {dev}")
    _check("x", x, 4, dev)
    _check("w", w, 4, dev)
    bsz, cin, h, wd = x.shape
    cout = w.shape[1]
    if stride != STRIDE or tuple(w.shape) != (cin, cout, KERNEL, KERNEL):
        raise ValueError(f"deconv2d_s2k5 takes kernel {KERNEL}, stride {STRIDE} and weights "
                         f"({cin}, Cout, {KERNEL}, {KERNEL}); got stride {stride}, weights "
                         f"{tuple(w.shape)}")
    if b is not None:
        _check("b", b, 1, dev)
        if b.shape[0] != cout:
            raise ValueError(f"b: {b.shape[0]} channels, want {cout}")
    if min(bsz, cin, cout, h, wd) <= 0 or bsz > 65535:
        raise ValueError(f"deconv2d_s2k5: unsupported shape x {tuple(x.shape)}, Cout {cout}")
    inst = INSTANCES[plan(cout)]
    coutp = -(-cout // inst.cot) * inst.cot
    wp = pack_weight(w, coutp)  # a new tensor, so its 16-byte rows are aligned
    y = torch.empty((bsz, cout, STRIDE * h, STRIDE * wd), dtype=torch.float32, device=dev)
    rc = _fn()(inst.index, x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
               y.data_ptr(), bsz, cin, cout, coutp, h, wd,
               _VP(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"deconv2d_s2k5 kernel launch failed: cudaError {rc}")
    count("launch:deconv2d")
    return y
