"""PyTorch port: multi-process start-up, the port's counterpart of
tests/test_multihost.py.

Two CPU processes join one gloo process group through
`parallel.distributed.initialize_from_env` from COORDINATOR_ADDRESS /
PROCESS_COUNT / PROCESS_ID (tests/torch_port_ranks.py, `init="env"`), then
exercise the pod-run path: host-striped `ImageFolderDataset` (disjoint and
covering), the trainer's own striping (`cli/train._datasets`), an
all_reduce over the group, and `allreduce_metrics` (mean 15.0).  Without a
process group `initialize_from_env` is (0, 1) and the metrics come back
unchanged; an nccl group with more ranks than cards is refused.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torch_port_ranks
from progressivecodec_tpu_torch.parallel import distributed


def rank_job(rank, world, workdir):
    from types import SimpleNamespace

    from progressivecodec_tpu_torch.cli import train as train_cli
    from progressivecodec_tpu_torch.config import TrainConfig
    from progressivecodec_tpu_torch.data.datasets import ImageFolderDataset

    pid, n = distributed.process_index_count()
    ds = ImageFolderDataset(str(workdir / "data"), "train", 8, host_index=pid, host_count=n)
    args = SimpleNamespace(natural=False, synthetic=False, train_dir=str(workdir / "data"),
                           test_dir=str(workdir / "kodak"))
    train_ds, _, _ = train_cli._datasets(args, TrainConfig(num_images=8))
    total = distributed.all_reduce(torch.full((2,), float(rank + 1)))
    metrics = distributed.allreduce_metrics(
        {"loss": float(10 * (rank + 1)), "per_q": torch.tensor([rank, 2.0 * rank])})
    return {
        "index_count": (pid, n),
        "local": [os.path.basename(f) for f in ds.files],
        "trainer": [os.path.basename(f) for f in train_ds.files],
        "psum": float(total.sum()),
        "loss_mean": metrics["loss"],
        "per_q": metrics["per_q"].tolist(),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from PIL import Image

    workdir = tmp_path_factory.mktemp("multihost")
    data = workdir / "data" / "train" / "data"
    data.mkdir(parents=True)
    for i in range(8):
        Image.fromarray(np.full((8, 8, 3), i * 30, np.uint8)).save(data / f"img{i}.png")
    (workdir / "kodak").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(workdir / "kodak" / "kodim01.png")
    return torch_port_ranks.run_ranks("test_torch_port_multihost", workdir, init="env",
                                      timeout=180)


@pytest.mark.timeout(300)
def test_initialize_from_env_joins_two_processes(ranks):
    assert [r["index_count"] for r in ranks] == [(0, 2), (1, 2)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("key", ["local", "trainer"])
def test_host_striping_disjoint_and_covering(ranks, key):
    s0, s1 = (set(r[key]) for r in ranks)
    assert s0.isdisjoint(s1)
    assert s0 | s1 == {f"img{i}.png" for i in range(8)}


@pytest.mark.timeout(300)
def test_all_reduce_and_metric_mean(ranks):
    for r in ranks:
        # (1, 1) + (2, 2) summed over the group: 6 in all, as JAX's psum
        assert r["psum"] == 6.0
        assert r["loss_mean"] == 15.0
        assert r["per_q"] == [0.5, 1.0]


def test_single_process_is_rank_zero_of_one(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert distributed.initialize_from_env() == (0, 1)
    metrics = {"loss": 1.5, "bpp": torch.tensor(0.25)}
    assert distributed.allreduce_metrics(metrics) is metrics


def test_nccl_without_a_card_per_rank_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(ValueError, match="gloo"):
        distributed.init_process_group(f"file://{tmp_path / 'store'}", 1, 0)
    with pytest.raises(ValueError, match="gloo"):
        distributed.init_process_group(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    assert distributed.process_index_count() == (0, 1)
