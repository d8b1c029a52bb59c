"""Convolution geometry of the reference, in NCHW.

Counterpart of `progressivecodec_tpu/ops/conv.py`: Conv2d(k, s, padding
k//2) and ConvTranspose2d(k, s, padding k//2, output_padding s-1), a
torch-ordered pixel shuffle, and the /64 image padding.  Weights are OIHW
for convs and IOHW for deconvs, as torch keeps them; `compute_padding`,
`pad_image` and `unpad_image` take NHWC images like the JAX package.

`deconv2d` on a CUDA tensor with autograd off runs the hand-written
kernel of `ops/deconv_cuda.py` (kernel 5, stride 2; it raises for any other
geometry).  The CPU takes `F.conv_transpose2d`; so do a CUDA tensor under
autograd (the kernel has no backward) and under FlopCounterMode (which
counts only ATen), and each such CUDA call counts `fallback:deconv2d`, which
stays 0 on the codec's inference path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import flop_counter
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from progressivecodec_tpu_torch.ops import deconv_cuda
from progressivecodec_tpu_torch.utils.profiling import count

# the dispatch mode FlopCounterMode pushes (the class itself before torch 2.4)
_FLOP_MODE = getattr(flop_counter, "_FlopCounterMode", flop_counter.FlopCounterMode)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1) -> torch.Tensor:
    """x (B, Cin, H, W), w (Cout, Cin, k, k) -> (B, Cout, H', W')."""
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def deconv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
             stride: int = 2) -> torch.Tensor:
    """x (B, Cin, H, W), w (Cin, Cout, k, k) -> (B, Cout, H*s, W*s)."""
    if x.is_cuda:
        if not _aten_only(x, w, b):
            return deconv_cuda.deconv2d_s2k5(x, w, b, stride=stride)
        count("fallback:deconv2d")
    k = w.shape[-1]
    return F.conv_transpose2d(
        x, w, b, stride=stride, padding=k // 2, output_padding=stride - 1
    )


def _aten_only(*tensors) -> bool:
    """Autograd or FlopCounterMode has to see the operation as ATen."""
    grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
    return grad or any(isinstance(m, _FLOP_MODE) for m in _get_current_dispatch_mode_stack())


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW pixel shuffle: channel c*r*r + i*r + j -> channel c at (i, j)."""
    return F.pixel_shuffle(x, r)


def compute_padding(h: int, w: int, min_div: int = 64):
    """Centered padding to a multiple of `min_div`: ((top, bottom), (left, right))."""
    new_h = (h + min_div - 1) // min_div * min_div
    new_w = (w + min_div - 1) // min_div * min_div
    ph, pw = new_h - h, new_w - w
    top, left = ph // 2, pw // 2
    return (top, ph - top), (left, pw - left)


def pad_image(x: torch.Tensor, min_div: int = 64):
    """Zero-pad an NHWC image batch to /min_div; returns (padded, pads)."""
    (t, bm), (l, r) = compute_padding(x.shape[1], x.shape[2], min_div)
    return F.pad(x, (0, 0, l, r, t, bm)), ((t, bm), (l, r))


def unpad_image(x: torch.Tensor, pads) -> torch.Tensor:
    (t, bm), (l, r) = pads
    h, w = x.shape[1], x.shape[2]
    return x[:, t : h - bm, l : w - r, :]
