"""Datasets: image folders, Kodak, seeded synthetic images, and the
random-crop patch loader of training.

Counterpart of `progressivecodec_tpu/data/datasets.py` (`load_image`,
`ImageFolderDataset` with its image cap and host striping, `KodakDataset`,
`random_crop`, `PatchLoader`, `NaturalSyntheticDataset` with its uint8
cache, `SyntheticKodak`, `SyntheticDataset`, `ImportanceMapDataset`).
Each image is an HWC float32 numpy array in [0, 1]; the synthetic sets
are generated from their seeds with numpy, and the loader draws its crops as JAX's does, so with one worker its batches equal the
JAX package's exactly.  PIL is imported only when an image file is read.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def load_image(path: str) -> np.ndarray:
    """RGB float32 HWC in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _list_images(root: str) -> list[str]:
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.lower().endswith(_EXTS))


class ImageFolderDataset:
    """The images of `root/split/data` (or `root/split`, or `root`), sorted
    by name, the first `num_images` of them, striped across hosts: host h of
    H takes files[h::H]."""

    def __init__(self, root: str, split: str = "train", num_images: int | None = None,
                 host_index: int = 0, host_count: int = 1):
        base = os.path.join(root, split, "data")
        if not os.path.isdir(base):
            base = os.path.join(root, split)
        if not os.path.isdir(base):
            base = root
        files = _list_images(base)
        if num_images:
            files = files[:num_images]
        self.files = files[host_index::host_count]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        return load_image(self.files[i])


class KodakDataset(ImageFolderDataset):
    def __init__(self, root: str):
        super().__init__(root, split="")
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """A random size x size crop; smaller images are reflect-padded first."""
    h, w = img.shape[:2]
    if h < size or w < size:
        img = np.pad(img, ((0, max(0, size - h)), (0, max(0, size - w)), (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top : top + size, left : left + size]


class PatchLoader:
    """Random-crop batches (B, size, size, 3) with background prefetch.

    Each epoch takes a permutation of the dataset from seed + epoch and
    cuts it into whole batches; `workers` threads build the batches, worker
    w drawing its crops from seed * 7919 + epoch * 131 + w, and the batches
    are served in order."""

    def __init__(self, dataset, batch_size: int, patch_size: int, seed: int = 0,
                 prefetch: int = 4, workers: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.seed = seed
        self.prefetch = prefetch
        self.workers = workers

    def epoch(self, epoch_idx: int = 0) -> Iterator[np.ndarray]:
        order = np.random.default_rng(self.seed + epoch_idx).permutation(len(self.dataset))
        n_batches = len(order) // self.batch_size
        ahead = max(self.prefetch, 1)
        tasks: queue.Queue = queue.Queue()
        for b in range(n_batches):
            tasks.put((b, order[b * self.batch_size : (b + 1) * self.batch_size]))
        results: dict[int, np.ndarray] = {}
        ready = threading.Condition()
        served = 0

        def worker(wid: int):
            rng = np.random.default_rng(self.seed * 7919 + epoch_idx * 131 + wid)
            while True:
                try:
                    b, ids = tasks.get_nowait()
                except queue.Empty:
                    return
                batch = np.stack([random_crop(self.dataset[int(i)], self.patch_size, rng)
                                  for i in ids])
                with ready:  # at most `prefetch` batches ahead of the consumer
                    ready.wait_for(lambda: b < served + ahead)
                    results[b] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        try:
            while served < n_batches:
                with ready:
                    ready.wait_for(lambda: served in results)
                    batch = results.pop(served)
                    served += 1
                    ready.notify_all()
                yield batch
        finally:
            # a consumer that stops early: drop the batches not started and
            # release the workers waiting on the prefetch bound
            while True:
                try:
                    tasks.get_nowait()
                except queue.Empty:
                    break
            with ready:
                served = n_batches + ahead
                ready.notify_all()
            for t in threads:
                t.join()


def _pink_field(rng: np.random.Generator, h: int, w: int, alpha: float) -> np.ndarray:
    """(h, w, 3) correlated 1/f^alpha random field, zero mean, about unit std."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    radius = np.sqrt(fy * fy + fx * fx)
    radius[0, 0] = 1.0
    filt = radius ** (-alpha)
    filt[0, 0] = 0.0
    spec = rng.standard_normal((h, w // 2 + 1, 3)) + 1j * rng.standard_normal(
        (h, w // 2 + 1, 3)
    )
    field = np.fft.irfft2(spec * filt[..., None], s=(h, w), axes=(0, 1))
    field /= field.std(axis=(0, 1), keepdims=True) + 1e-8
    # pull the channels toward a shared luminance, as in natural images
    mix = 0.75 * np.ones((3, 3)) / 3.0 + 0.25 * np.eye(3)
    return field @ mix.astype(field.dtype)


def natural_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """An (h, w, 3) image with natural-image statistics: a 1/f power
    spectrum, textured regions, an illumination gradient and anti-aliased
    occluders."""
    alpha = rng.uniform(0.9, 1.7)
    img = 0.22 * _pink_field(rng, h, w, alpha)
    # fine texture in random regions
    tex = 0.06 * _pink_field(rng, h, w, 0.4)
    tex_gate = _pink_field(rng, h, w, 2.2)[..., :1]
    img += tex * (tex_gate > 0.3)
    # global illumination gradient
    yy = np.linspace(-1, 1, h)[:, None, None]
    xx = np.linspace(-1, 1, w)[None, :, None]
    g = rng.uniform(-0.15, 0.15, size=(2, 1))
    img += g[0] * yy + g[1] * xx
    # anti-aliased occluders: sharp edges, flat or gradient fill
    for _ in range(int(rng.integers(2, 6))):
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        ry, rx = rng.uniform(0.05, 0.35) * h, rng.uniform(0.05, 0.35) * w
        theta = rng.uniform(0, np.pi)
        dy, dx = (yy[..., 0] * h / 2 + h / 2 - cy), (xx[:, :, 0] * w / 2 + w / 2 - cx)
        u = dy * np.cos(theta) + dx * np.sin(theta)
        v = -dy * np.sin(theta) + dx * np.cos(theta)
        if rng.random() < 0.5:  # ellipse
            d = np.sqrt((u / ry) ** 2 + (v / rx) ** 2) - 1.0
        else:  # rotated rectangle
            d = np.maximum(np.abs(u) / ry, np.abs(v) / rx) - 1.0
        cover = np.clip(0.5 - d * 8.0, 0.0, 1.0)[..., None]
        color = rng.uniform(-0.4, 0.4, size=(3,))
        grad = rng.uniform(-0.1, 0.1) * (u / max(ry, 1.0))[..., None]
        img = img * (1 - 0.85 * cover) + (color + grad) * cover * 0.85
    img += rng.uniform(0.3, 0.7)  # brightness
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class NaturalSyntheticDataset:
    """`n` seeded `size` x `size` images with natural-image statistics
    (`natural_image`), each generated from seed * 100003 + its index.  With
    `cache`, the first read of an index returns the generated float image
    and keeps a uint8 copy, and later reads return that copy as float."""

    def __init__(self, n: int = 4000, size: int = 384, seed: int = 0, cache: bool = True):
        self.n = n
        self.size = size
        self.seed = seed
        self._cache: dict[int, np.ndarray] | None = {} if cache else None

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        if self._cache is not None and i in self._cache:
            return self._cache[i].astype(np.float32) / 255.0
        img = natural_image(np.random.default_rng(self.seed * 100003 + i), self.size, self.size)
        if self._cache is not None:
            self._cache[i] = (img * 255.0 + 0.5).astype(np.uint8)
        return img


class SyntheticKodak:
    """A fixed set of `n` synthetic 768x512 images (Kodak's geometry)."""

    def __init__(self, n: int = 24, seed: int = 77):
        self.n = n
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 9176 + i)
        return natural_image(rng, 512, 768)


class SyntheticDataset:
    """Seeded smooth random images (an 8x-upsampled random field plus noise)."""

    def __init__(self, n: int = 64, size: int = 512, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + i)
        small = rng.random((self.size // 8, self.size // 8, 3)).astype(np.float32)
        img = np.kron(small, np.ones((8, 8, 1), np.float32))
        img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
        return np.clip(img, 0.0, 1.0)


class ImportanceMapDataset:
    """Pairs (image patch, gradient importance map) for MaskEstractor
    training, each map computed when its item is read.

    Item i crops with `np.random.default_rng(seed + i)` as JAX does (the
    same patch), pads it to a multiple of 64 and runs
    `layers.importance.importance_map` on the model's device with a
    `torch.Generator` seeded `seed + i`.  The map's draws come from torch's
    generator, not JAX's PRNG, so its values differ from the JAX package's
    for the same seed.  Returns (patch HWC float32, map (h, w, C) float32)."""

    def __init__(self, base_dataset, model, scale_table, patch_size: int = 256, seed: int = 0):
        self.base = base_dataset
        self.model = model
        self.scale_table = scale_table
        self.patch_size = patch_size
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int):
        import torch

        from progressivecodec_tpu_torch.layers.importance import importance_map
        from progressivecodec_tpu_torch.ops.conv import pad_image
        from progressivecodec_tpu_torch.ops.noise import NoiseSource

        patch = random_crop(self.base[i], self.patch_size, np.random.default_rng(self.seed + i))
        device = next(self.model.parameters()).device
        x = torch.as_tensor(np.ascontiguousarray(patch), dtype=torch.float32, device=device)[None]
        x_pad, _ = pad_image(x, 64)
        imap = importance_map(self.model, x_pad, NoiseSource.seeded(self.seed + i),
                              self.scale_table)
        return patch, imap[0].cpu().numpy()
