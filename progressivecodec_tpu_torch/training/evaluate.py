"""Evaluation: the real codec per quality, and its entropy-estimate partner.

Counterpart of `progressivecodec_tpu/training/evaluate.py`.  Each image is
padded to a multiple of 64, coded at every quality of the ladder and
decoded; bpp comes from the stream's bytes, PSNR and MS-SSIM (dB) from the
decoded image.  Encode and decode times are read on the host clock after
`torch.cuda.synchronize()` on the card.
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from progressivecodec_tpu_torch.ops.conv import pad_image, unpad_image
from progressivecodec_tpu_torch.utils.metrics import ms_ssim_db, psnr


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _image(codec, img) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img), dtype=torch.float32, device=codec.device)[None]


def evaluate_codec(codec, images: Iterable[np.ndarray], pr_list: Sequence[float] = (0.0, 10.0),
                   mask_pol: str | None = None, verify_stream: bool = True) -> dict:
    """images: HWC float arrays in [0, 1].  Returns {"bpp", "psnr",
    "ms_ssim_db", "enc_time", "dec_time"} (one mean per quality, times in
    seconds) and "n_images"."""
    k = len(pr_list)
    acc = {key: np.zeros(k) for key in ("bpp", "psnr", "ms_ssim_db", "enc_time", "dec_time")}
    n = 0
    for img in images:
        x = _image(codec, img)
        x_pad, pads = pad_image(x, 64)
        num_pixels = x.shape[1] * x.shape[2]
        for j, q in enumerate(pr_list):
            _sync(codec.device)
            t0 = time.perf_counter()
            data = codec.compress(x_pad, quality=q, mask_pol=mask_pol)
            _sync(codec.device)
            enc_t = time.perf_counter() - t0

            t0 = time.perf_counter()
            out = codec.decompress(data)
            _sync(codec.device)
            dec_t = time.perf_counter() - t0
            if verify_stream and not out["stream_ok"]:
                raise RuntimeError(f"stream integrity failure at q={q}")

            x_hat = unpad_image(out["x_hat"], pads)
            acc["bpp"][j] += data["num_bytes"] * 8.0 / num_pixels
            acc["psnr"][j] += float(psnr(x, x_hat))
            acc["ms_ssim_db"][j] += float(ms_ssim_db(x, x_hat))
            acc["enc_time"][j] += enc_t
            acc["dec_time"][j] += dec_t
        n += 1
    if n == 0:
        raise ValueError("no images")
    return {**{key: (v / n).tolist() for key, v in acc.items()}, "n_images": n}


def entropy_estimate_eval(codec, images: Iterable[np.ndarray],
                          pr_list: Sequence[float] = (0.0, 10.0), mask_pol: str | None = None,
                          lmbda_list: Sequence[float] | None = None) -> dict:
    """Likelihood bpp and PSNR of the single-quality eval forward, the
    cross-check of `evaluate_codec`.  With `lmbda_list`, also "loss": bpp +
    255^2 * mean(lmbda) * mse, averaged over the qualities and images (the
    validation criterion of the reference's trainer)."""
    k = len(pr_list)
    bpp, ps, mses = np.zeros(k), np.zeros(k), np.zeros(k)
    n = 0
    for img in images:
        x = _image(codec, img)
        x_pad, pads = pad_image(x, 64)
        denom = -math.log(2) * x.shape[1] * x.shape[2]
        for j, q in enumerate(pr_list):
            out = codec.forward_single_quality(x_pad, q, mask_pol)
            lik = out["likelihoods"]
            bpp[j] += float(torch.sum(torch.log(lik["y"])) / denom
                            + torch.sum(torch.log(lik["z"])) / denom)
            x_hat = unpad_image(out["x_hat"], pads)
            ps[j] += float(psnr(x, x_hat))
            mses[j] += float(torch.mean((x - x_hat) ** 2))
        n += 1
    if n == 0:
        raise ValueError("no images")
    result = {"bpp": (bpp / n).tolist(), "psnr": (ps / n).tolist(), "n_images": n}
    if lmbda_list is not None:
        lm = float(np.mean(lmbda_list))
        result["loss"] = float(np.mean(bpp / n + 255.0**2 * lm * (mses / n)))
    return result
