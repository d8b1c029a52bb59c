"""PyTorch port: `ops/math.lower_bound` and `layers/masking.row_quantile`
keep their bounds and weights as Python numbers, and compute the bits of
the form that copied each of them to the tensor's device first (kept here
as `_TensorLowerBound` and `tensor_row_quantile`).  Compared as int32 bit
patterns:
  * lower_bound, forward and gradient, at the bounds 0, 2^-18,
    sqrt(1e-6 + pedestal), 0.11 and 1e-9, on inputs holding NaN, +-inf,
    +-0, subnormals, float32(bound) and its neighbours;
  * row_quantile at q = 0, 1 and 1 - Q/10 for every Q of `QUALITY_GRID`,
    on rows holding NaN, ties, infinities and a single element, at the row
    lengths of the flagship's stacked mask and REM's per-slice mask at the
    TINY (64x64 image) and Kodak (768x512) latent sizes.

On the card the two forms give the same bits in every element.  On the
CPU the tensor form's bits depend on the element's place in the vector at
two kinds of element: a NaN comes out all ones in the vector lanes and
0x7fc00000 in the scalar tail, and at a zero bound a +-0 input gets the
bound's zero in the vector lanes and its own in the tail.  There the CPU
cases ask both forms for a NaN and for a zero, and the same bits
everywhere else.

The cases marked `cuda` run the same comparisons on the card.  This file
imports no JAX, so the card runs it:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_scalar_bounds.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from progressivecodec_tpu_torch.layers.masking import row_quantile
from progressivecodec_tpu_torch.ops.math import PEDESTAL, REPARAM_OFFSET, lower_bound
from progressivecodec_tpu_torch.utils.rd import QUALITY_GRID

F32 = torch.float32
BOUNDS = [0.0, REPARAM_OFFSET, (1e-6 + PEDESTAL) ** 0.5, 0.11, 1e-9]
QS = [0.0, 1.0] + [1.0 - q / 10 for q in QUALITY_GRID]
# (rows, row length): the flagship ranks its enhancement slices stacked,
# one row per slice and image; REM ranks one slice of one image per call.
# A row is H/16 x W/16 x dim_chunk: TINY 4x4x8, Kodak 32x48x32.
ROWS = {"single": (3, 1), "tiny_flagship": (4, 128), "tiny_rem": (1, 128),
        "kodak_flagship": (10, 49_152), "kodak_rem": (1, 49_152)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


class _TensorLowerBound(torch.autograd.Function):
    """The bound copied to x's device as a 0-dim tensor of x's dtype."""

    @staticmethod
    def forward(ctx, x, bound):
        bound_t = torch.as_tensor(bound, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, bound_t)
        return torch.maximum(x, bound_t)

    @staticmethod
    def backward(ctx, g):
        x, bound_t = ctx.saved_tensors
        pass_through = (x >= bound_t) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def tensor_row_quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """row_quantile with its weights and NaN copied to flat's device."""
    n = flat.shape[1]
    srt = torch.sort(flat, dim=1).values
    qf = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(qf), np.ceil(qf)
    high_w = qf - low
    low_w = np.float32(1.0) - high_w
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    w = lambda v: torch.tensor(v, dtype=F32, device=flat.device)  # noqa: E731
    out = srt[:, lo_i] * w(low_w) + srt[:, hi_i] * w(high_w)
    return torch.where(torch.isnan(flat).any(dim=1), w(np.nan), out)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def bound_inputs(bound: float) -> tuple[np.ndarray, np.ndarray]:
    """(x, g): the special values and the bound's neighbours among normal
    draws, shuffled over 301 elements (vector lanes and a scalar tail)."""
    b = np.float32(bound)
    tiny = np.finfo(np.float32).tiny
    special = np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, tiny, -tiny, tiny / 2, -tiny / 2,
         np.float32(1e-45), -np.float32(1e-45), b, b, -b, np.nextafter(b, np.float32(np.inf)),
         np.nextafter(b, np.float32(-np.inf)), bound, -bound], np.float32)
    rng = np.random.default_rng(15)
    x = rng.normal(0, 1, 301).astype(np.float32)
    x[: 4 * special.size] = np.tile(special, 4)
    x = x[rng.permutation(x.size)]
    g = rng.normal(0, 1, x.size).astype(np.float32)
    g[::7], g[1::7] = 0.0, -0.0
    g[2::11] = np.nan
    return x, g


def quantile_rows(rows: int, n: int, seed: int) -> np.ndarray:
    """Sigma-like rows, then one with a NaN, one of ties, one with +-inf."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(0, 1, (rows, n))).astype(np.float32)
    nan_row = base[0].copy()
    nan_row[rng.integers(n)] = np.nan
    ties = rng.choice(np.float32([0.11, 0.25, 0.25, 1.5]), n).astype(np.float32)
    infs = base[-1].copy()
    infs[: max(1, n // 3)] = np.inf
    infs[-1] = -np.inf if n > 1 else infs[-1]
    return np.concatenate([base, nan_row[None], ties[None], infs[None]])


def check_lower_bound(bound: float, device) -> None:
    x_np, g_np = bound_inputs(bound)
    outs = {}
    for name, fn in (("scalar", lower_bound), ("tensor", _TensorLowerBound.apply)):
        x = torch.from_numpy(x_np).to(device).requires_grad_(True)
        y = fn(x, bound)
        y.backward(torch.from_numpy(g_np).to(device))
        outs[name] = (bits(y), bits(x.grad))
    (y_s, g_s), (y_t, g_t) = outs["scalar"], outs["tensor"]
    np.testing.assert_array_equal(g_s, g_t)
    if torch.device(device).type == "cuda":
        np.testing.assert_array_equal(y_s, y_t)
    nan = np.isnan(x_np)
    tie = (x_np == 0) & (np.float32(bound) == 0)
    np.testing.assert_array_equal(y_s[~nan & ~tie], y_t[~nan & ~tie])
    for y in (y_s.view(np.float32), y_t.view(np.float32)):
        assert np.isnan(y[nan]).all() and (y[tie] == 0).all()
    # a finite input above the bound, or at it but for a tie, passes unchanged
    keep = np.isfinite(x_np) & (x_np >= np.float32(bound)) & ~tie
    np.testing.assert_array_equal(y_s[keep], x_np.view(np.int32)[keep])


def check_row_quantile(rows: int, n: int, device) -> None:
    flat = torch.from_numpy(quantile_rows(rows, n, seed=rows * 7 + n)).to(device)
    for q in QS:
        got, want = row_quantile(flat, q), tensor_row_quantile(flat, q)
        assert got.dtype == F32 and got.device == flat.device
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"q={q}")
        assert torch.isnan(got[rows]).item()


@pytest.mark.parametrize("bound", BOUNDS)
def test_lower_bound_bits_equal_the_tensor_bound(bound):
    check_lower_bound(bound, "cpu")


@pytest.mark.parametrize("rows", list(ROWS))
def test_row_quantile_bits_equal_the_tensor_weights(rows):
    check_row_quantile(*ROWS[rows], "cpu")


def test_lower_bound_keeps_the_bound_on_the_graph():
    """The bound rides on the autograd context, not as a saved tensor: a
    second backward through a kept graph reads it again.  float32(0.11)
    passes: the comparison is made in x's dtype, as against the tensor."""
    x = torch.tensor([0.05, 0.11, 0.2, -1.0], requires_grad=True)
    y = lower_bound(x, 0.11)
    g = torch.tensor([1.0, 1.0, 1.0, -1.0])
    (g1,) = torch.autograd.grad(y, x, g, retain_graph=True)
    (g2,) = torch.autograd.grad(y, x, -g)
    np.testing.assert_array_equal(g1.numpy(), [0.0, 1.0, 1.0, -1.0])
    np.testing.assert_array_equal(g2.numpy(), [-1.0, -1.0, -1.0, 0.0])


@pytest.mark.cuda
@pytest.mark.parametrize("bound", BOUNDS)
def test_lower_bound_bits_equal_the_tensor_bound_on_the_card(cuda_device, bound):
    check_lower_bound(bound, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(ROWS))
def test_row_quantile_bits_equal_the_tensor_weights_on_the_card(cuda_device, rows):
    check_row_quantile(*ROWS[rows], cuda_device)
