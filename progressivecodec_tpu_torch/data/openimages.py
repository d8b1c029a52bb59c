"""OpenImages downloader, gated on the optional `fiftyone` package.

Counterpart of `progressivecodec_tpu/data/openimages.py`: the reference's
dataset bootstrap (OpenImages-v6 through the fiftyone zoo, 300k train / 10k
test, exported to the `root/split/data` layout that `ImageFolderDataset`
reads).  fiftyone is imported only when the download is asked for, and its
absence raises an ImportError that says what to do offline.
"""

from __future__ import annotations

import os


def download_openimages(root: str, n_train: int = 300_000, n_test: int = 10_000,
                        seed: int = 51) -> None:
    """Download the OpenImages-v6 train and test splits into
    root/train/data/*.jpg and root/test/data/*.jpg.  Needs `fiftyone` and
    network access."""
    try:
        import fiftyone.zoo as foz
    except ImportError as e:
        raise ImportError(
            "download_openimages needs the optional 'fiftyone' package "
            "(pip install fiftyone) and network access; in offline "
            "environments use data.datasets.NaturalSyntheticDataset or "
            "point --train-dir at an existing root/split/data layout"
        ) from e

    for split, n in (("train", n_train), ("test", n_test)):
        ds = foz.load_zoo_dataset(
            "open-images-v6", split="validation" if split == "test" else split,
            max_samples=n, seed=seed, shuffle=True,
        )
        out = os.path.join(root, split, "data")
        os.makedirs(out, exist_ok=True)
        ds.export(export_dir=out, dataset_type="image-directory")
