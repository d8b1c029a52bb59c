"""Width tiling of large images over the ranks of a mesh axis, with halo exchange.

Counterpart of `progressivecodec_tpu/parallel/tiling.py`.  A wide image is
cut into width tiles, one per rank of the axis.  Every dependency of the
transforms is local (bounded receptive fields; window attention strictly
windowed, the Swin shift's wraparound neutralised by its mask), so each
rank runs the transform on its tile padded with `halo` columns of its
neighbours' tiles, sent and received point to point, and drops the halo
afterwards.  That reproduces the full-width transform up to float
reassociation (< 2e-5 on unit-scale activations): the per-tile and the
full-width convolutions may take other algorithms.

Exactness contract, as in JAX:
  * sigma, the quantile mask and the CDF indexes come from the decoded z
    and base slices through the codec's own fragments, which tiling never
    touches, so a stream encoded tiled decodes on any topology;
  * the tiled stream equals the untiled one unless the analysis's
    difference flips a symbol's rounding or a quantile threshold.

SPMD, as in JAX: every rank is given the global tensor, computes its tile,
and gets the global result back by all_gather.  JAX's compile caches
(`_SHARDED_CACHE`, `_model_key`) have no counterpart: nothing is compiled.

Halo: the one-sided receptive extent of g_a in input pixels is 174, rounded
up to 192 (a multiple of the total stride 16, and of 64 so the Swin window
grids of a padded tile align with the global grids at every scale).
"""

from __future__ import annotations

import torch

from progressivecodec_tpu_torch.layers.masking import row_quantile
from progressivecodec_tpu_torch.models.transforms import nchw, nhwc
from progressivecodec_tpu_torch.parallel.distributed import all_gather_cat, exchange
from progressivecodec_tpu_torch.parallel.mesh import check_axis

HALO = 192  # input-space one-sided halo of g_a (see the module docstring)
STRIDE = 16  # total downsampling of g_a, upsampling of g_s


def _tile(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's width tile of x (B, H, W, C)."""
    check_axis(mesh, axis)
    n, i = mesh[axis].size(), mesh.get_local_rank(axis)
    tile_w = x.shape[2] // n
    return x[:, :, i * tile_w : (i + 1) * tile_w]


def _exchange_halo_w(x: torch.Tensor, halo: int, mesh, axis: str):
    """Pad this rank's tile x (B, H, W_local, C) with `halo` columns of each
    width neighbour's tile.  Returns (padded (B, H, W_local + 2 halo, C),
    valid_start).

    Edge alignment: the Swin shift mask isolates the segments at a true
    image edge, so a tile holding a global edge must END there.  The first
    tile is laid out [x | right halo | 0], the last [0 | left halo | x], an
    interior one [left halo | x | right halo]; the valid region starts at
    column 0, 2 halo and halo.  (A [0 | x | halo] first tile has the same
    shape and the wrong attention masks.)  A tile that holds both edges,
    the one tile of a one-rank axis, is x itself: padded on either side, it
    would end or start away from an edge.  (JAX lays it out [x | 0 | 0],
    which is not exact at the right edge.)"""
    n, i = mesh[axis].size(), mesh.get_local_rank(axis)
    if n == 1:
        return x, 0
    sends, recvs = {}, {}
    if i > 0:  # my left strip is the left neighbour's right halo
        sends[i - 1] = x[:, :, :halo]
        recvs[i - 1] = x[:, :, :halo]
    if i < n - 1:
        sends[i + 1] = x[:, :, -halo:]
        recvs[i + 1] = x[:, :, -halo:]
    got = exchange(sends, recvs, mesh.get_group(axis))
    zeros = torch.zeros_like(x[:, :, :halo])
    if i == 0:
        return torch.cat([x, got.get(1, zeros), zeros], dim=2), 0
    if i == n - 1:
        return torch.cat([zeros, got[i - 1], x], dim=2), 2 * halo
    return torch.cat([got[i - 1], x, got[i + 1]], dim=2), halo


def tiled_apply_transform(fn, x: torch.Tensor, mesh, *, halo: int = HALO, stride: int = STRIDE,
                          axis: str = "model") -> torch.Tensor:
    """Apply an image -> latent transform over width tiles exactly.

    fn: (B, H, W, C) -> (B, H/stride, W/stride, C').  x: the global image
    (B, H, W, C), the same on every rank; W must be a multiple of
    tiles * stride.  Each rank runs fn on its halo-padded tile and drops
    the halo; the result is the global latent on every rank."""
    check_axis(mesh, axis)
    n = mesh[axis].size()
    w = x.shape[2]
    if w % (n * stride):
        raise ValueError(f"W={w} is not a multiple of tiles*stride = {n}*{stride}")
    tile_w = w // n
    # halo a multiple of 64: the Swin window grids of the padded tile align
    # with the global window grids at every scale
    if halo % 64 or (n > 1 and halo > tile_w):
        raise ValueError(f"halo {halo} must be <= the tile width {tile_w} and a multiple of 64")
    local = _tile(x, mesh, axis)
    padded, valid_start = _exchange_halo_w(local, halo, mesh, axis)
    y = fn(padded).narrow(2, valid_start // stride, tile_w // stride)
    return all_gather_cat(y.contiguous(), mesh.get_group(axis), dim=2)


def global_quantile_mask(sigma: torch.Tensor, keep_frac: float, mesh,
                         axis: str = "model") -> torch.Tensor:
    """Per-image top-fraction mask ranked over the whole width.

    sigma: the global (B, h, w, C), the same on every rank.  Each rank
    thresholds its width tile at the quantile of the all_gathered sigma
    (`layers/masking.py`'s quantile, jnp.quantile's "linear" arithmetic),
    and the tiles' masks are gathered: equal bit for bit to
    `quantile_mask(sigma, keep_frac)`."""
    local = _tile(sigma, mesh, axis)
    group = mesh.get_group(axis)
    full = all_gather_cat(local.contiguous(), group, dim=2)
    q = row_quantile(full.reshape(full.shape[0], -1).to(torch.float32), 1.0 - keep_frac)
    mask = (local.to(torch.float32) >= q[:, None, None, None]).to(torch.float32)
    return all_gather_cat(mask, group, dim=2)


def tiled_analyze(model, x: torch.Tensor, mesh, *, axis: str = "model",
                  halo: int = HALO) -> torch.Tensor:
    """The tiled g_a: the full latent (B, H/16, W/16, M)."""
    return tiled_apply_transform(model.analyze, x, mesh, halo=halo, stride=STRIDE, axis=axis)


def tiled_synthesize(model, y_hat: torch.Tensor, mesh, *, decoder_index: int = 1,
                     axis: str = "model", halo_latent: int = 16) -> torch.Tensor:
    """The tiled g_s `decoder_index` (no refinement, not clipped): latent
    tiles with a latent-space halo -> the image (B, 16h, 16w, 3).

    The one-sided extent of g_s in latent pixels is bounded by 16 (256
    image pixels), which the equality tests confirm."""
    check_axis(mesh, axis)
    n = mesh[axis].size()
    tile_w = y_hat.shape[2] // n
    if n > 1 and halo_latent > tile_w:
        raise ValueError(f"halo_latent {halo_latent} > the tile width {tile_w}")
    net = model._synth_net(decoder_index)
    local = _tile(y_hat, mesh, axis)
    padded, valid_start = _exchange_halo_w(local, halo_latent, mesh, axis)
    x = nhwc(net(nchw(padded))).narrow(2, valid_start * STRIDE, tile_w * STRIDE)
    return all_gather_cat(x.contiguous(), mesh.get_group(axis), dim=2)


@torch.no_grad()
def tiled_compress(codec, x, mesh, *, quality: float = 10.0, mask_pol: str | None = None,
                   axis: str = "model", simulate: bool = False) -> dict:
    """Encode a large image: the analysis (the image-space FLOPs) width
    tiled with halo exchange, then the slices and the entropy coder on the
    gathered latent through the codec's own fragments (a coder_mesh codec
    shards the coder too).  `simulate` as for `compress_from_latent`."""
    codec.update()
    x = codec._as_input(x)
    y = tiled_analyze(codec.model, x, mesh, axis=axis)
    return codec.compress_from_latent(y, tuple(x.shape), quality=quality, mask_pol=mask_pol,
                                      simulate=simulate)


@torch.no_grad()
def tiled_decompress(codec, data: dict, mesh, *, axis: str = "model") -> dict:
    """Decode counterpart of `tiled_compress`: the entropy decode and the
    slices through the codec's fragments, then the synthesis width tiled.
    Returns {"x_hat" clipped to [0, 1], "stream_ok", "y_hat"}."""
    out = codec.decompress_to_latent(data)
    which = 0 if float(data["quality"]) == 0 else 1
    x_hat = tiled_synthesize(codec.model, out["y_hat"], mesh, decoder_index=which, axis=axis)
    return {"x_hat": torch.clamp(x_hat, 0.0, 1.0), "stream_ok": out["stream_ok"],
            "y_hat": out["y_hat"]}
