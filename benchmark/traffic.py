"""The traffic generator: one mix file under `benchmark/traffic/` drives it.

A mix (`<name>.json`) gives the image size, the batch, the qualities, the
pool of images and what the traced and the checked runs take:
  height, width, batch     each request codes `batch` images of this size
  qualities                the qualities a request draws from (each seen
                           once per cycle, in a seeded order)
  pool, pool_seed          images made at set-up from pool_seed, reused in an
                           order drawn from the run's seed
  warmup_qualities         one warm-up request at each, before the window
  profiled_requests        requests in the traced sub-window (`--trace 1`)
  check_requests, check_span
                           requests whose outputs are compared with the
                           reference: drawn from the first `check_span`

The images follow `natural_image` of
`progressivecodec_tpu_torch/data/datasets.py` (a 1/f spectrum, texture in
random regions, an illumination gradient, anti-aliased occluders), here in
torch on the device so that a pool of 2K images costs no set-up time.  The
image's spectral slope is stratified over the pool.  Every seed sends the
same images and qualities, in another order: the seed changes the order,
not the work, so runs of different seeds measure the same thing.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

F32 = torch.float32
SCHEDULE_CYCLES = 4096


def load_mix(root: Path, name: str) -> dict:
    with open(Path(root) / "benchmark" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _pink_field(gen, h: int, w: int, alpha: float, device) -> torch.Tensor:
    """(h, w, 3) correlated 1/f^alpha field, zero mean, about unit std."""
    fy = torch.fft.fftfreq(h, device=device, dtype=F32)[:, None]
    fx = torch.fft.rfftfreq(w, device=device, dtype=F32)[None, :]
    radius = torch.sqrt(fy * fy + fx * fx)
    radius[0, 0] = 1.0
    filt = radius ** (-alpha)
    filt[0, 0] = 0.0
    re_im = torch.randn((2, h, w // 2 + 1, 3), generator=gen, device=device, dtype=F32)
    spec = torch.complex(re_im[0], re_im[1]) * filt[..., None]
    field = torch.fft.irfft2(spec, s=(h, w), dim=(0, 1))
    field = field / (field.std(dim=(0, 1), correction=0, keepdim=True) + 1e-8)
    mix = 0.75 * torch.ones((3, 3), device=device) / 3.0 + 0.25 * torch.eye(3, device=device)
    return field @ mix


def natural_image(gen, rng: np.random.Generator, h: int, w: int, alpha: float, device) -> torch.Tensor:
    """An (h, w, 3) image in [0, 1] with natural-image statistics."""
    img = 0.22 * _pink_field(gen, h, w, alpha, device)
    tex = 0.06 * _pink_field(gen, h, w, 0.4, device)
    gate = _pink_field(gen, h, w, 2.2, device)[..., :1]
    img = img + tex * (gate > 0.3)
    yy = torch.linspace(-1, 1, h, device=device)[:, None, None]
    xx = torch.linspace(-1, 1, w, device=device)[None, :, None]
    g = rng.uniform(-0.15, 0.15, size=2)
    img = img + float(g[0]) * yy + float(g[1]) * xx
    for _ in range(int(rng.integers(2, 6))):
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        ry, rx = rng.uniform(0.05, 0.35) * h, rng.uniform(0.05, 0.35) * w
        theta = rng.uniform(0, np.pi)
        dy = yy[..., 0] * h / 2 + h / 2 - cy
        dx = xx[:, :, 0] * w / 2 + w / 2 - cx
        u = dy * math.cos(theta) + dx * math.sin(theta)
        v = -dy * math.sin(theta) + dx * math.cos(theta)
        if rng.random() < 0.5:
            d = torch.sqrt((u / ry) ** 2 + (v / rx) ** 2) - 1.0
        else:
            d = torch.maximum(torch.abs(u) / ry, torch.abs(v) / rx) - 1.0
        cover = torch.clamp(0.5 - d * 8.0, 0.0, 1.0)[..., None]
        color = torch.as_tensor(rng.uniform(-0.4, 0.4, size=3), dtype=F32, device=device)
        grad = float(rng.uniform(-0.1, 0.1)) * (u / max(ry, 1.0))[..., None]
        img = img * (1 - 0.85 * cover) + (color + grad) * cover * 0.85
    img = img + float(rng.uniform(0.3, 0.7))
    return torch.clamp(img, 0.0, 1.0).to(F32)


def image_pool(mix: dict, device) -> torch.Tensor:
    """(pool, H, W, 3) float32 on `device`, from the mix's `pool_seed`."""
    n, h, w = int(mix["pool"]), int(mix["height"]), int(mix["width"])
    seed = int(mix["pool_seed"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng([int(seed) % (1 << 63), 0])
    alphas = 0.9 + 0.8 * (np.arange(n) + 0.5) / n
    return torch.stack([natural_image(gen, rng, h, w, float(a), device) for a in alphas])


class Schedule:
    """Request i's image indices and quality: the pool and the qualities
    each walked in a fresh seeded order per cycle, so every seed sends the
    same mix of images and qualities in another order."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.batch = int(mix["batch"])
        pool = int(mix["pool"])
        qs = np.asarray(mix["qualities"], dtype=np.float64)
        self.images = np.concatenate([rng.permutation(pool) for _ in range(SCHEDULE_CYCLES)])
        self.qualities = np.concatenate([qs[rng.permutation(len(qs))] for _ in range(SCHEDULE_CYCLES)])
        span = int(mix["check_span"])
        self.checked = set(rng.choice(span, size=min(int(mix["check_requests"]), span),
                                      replace=False).tolist())

    def __call__(self, i: int) -> tuple[list, float]:
        """(pool indices, quality) of request i; the quality as float32 holds it."""
        n = len(self.images)
        idx = [int(self.images[(i * self.batch + j) % n]) for j in range(self.batch)]
        return idx, float(np.float32(self.qualities[i % len(self.qualities)]))
