"""PyTorch port: the REM tools (`tools/rem_demo.py`, `tools/rem_flagship.py`)
against JAX's transplant, at TINY (N=32, M=64, dim_chunk 8, division
(32, 64)) on the CPU.

  * the transplant of a stacked progressive checkpoint into REM (a
    `load_state_dict(strict=False)` missing exactly the banks) equals JAX's
    (`torch_import.unstack_prog_params` of the stacked tree merged into the
    REM tree), carried across by `from_jax_params`, leaf for leaf; a state
    dict with a stray key, or one that misses a base key, is refused;
  * `rem_config` log-interpolates the lmbda as JAX's tool does;
  * after 2 bank steps every parameter outside `post_latent.*` is unchanged
    bit for bit and at least one bank tensor moved;
  * `rem_flagship.main` on a checkpoint and `rem_demo.main` (2 base and 2
    bank steps) run on the CPU: REM with identity banks equals the frozen
    base exactly (the checkpoint's weights in the unrolled progressive
    model on the real codec; the trained base on the entropy estimate).
JAX here only maps trees: no JAX model runs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from progressivecodec_tpu.config import ModelConfig as JaxModelConfig
from progressivecodec_tpu.config import ScaleTableConfig as JaxScaleTableConfig
from progressivecodec_tpu.models.torch_import import (
    import_progressive,
    import_rem,
    unstack_prog_params,
)
from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.data.datasets import NaturalSyntheticDataset, PatchLoader
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.models.rem import BANKS
from progressivecodec_tpu_torch.models.weights import from_jax_params, init_params
from progressivecodec_tpu_torch.tools import profile_codec, rem_demo, rem_flagship
from progressivecodec_tpu_torch.training.checkpoint import save_checkpoint
from progressivecodec_tpu_torch.training.step import init_train_state

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_KW = dict(N=32, M=64, dim_chunk=8, division_dimension=(32, 64))
BASE = ModelConfig(name="channel", **TINY_KW, scale_table=ScaleTableConfig(levels=32))
JBASE = JaxModelConfig(name="channel", **TINY_KW, scale_table=JaxScaleTableConfig(levels=32))


class SmallKodak:
    """One seeded 192x192 image in SyntheticKodak's place (MS-SSIM's five
    scales fit)."""

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return np.random.default_rng(90 + i).random((192, 192, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def base_state():
    assert profile_codec.seeded_model(BASE, "cpu", 3).stacked
    return init_params(BASE, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def rem_cfg():
    return rem_flagship.rem_config(BASE)


def test_rem_config_like_jax(rem_cfg):
    lo, hi = BASE.lmbda_list[0], BASE.lmbda_list[-1]
    want = [float(np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * t)) for t in (0, 1 / 3, 2 / 3, 1)]
    assert rem_cfg.name == "rate" and not rem_cfg.stack_prog
    assert list(rem_cfg.lmbda_list) == want


def test_transplant_equals_jax(base_state, rem_cfg):
    rem = profile_codec.seeded_model(rem_cfg, "cpu", 1)
    rem_demo.transplant(base_state, rem)
    ours = rem.state_dict()

    jrem_cfg = dataclasses.replace(JBASE, name="rate", stack_prog=False,
                                   lmbda_list=rem_cfg.lmbda_list)
    stacked = import_progressive({k: v.numpy() for k, v in base_state.items()}, JBASE)
    rem_init = init_params(rem_cfg, torch.Generator().manual_seed(1))
    merged = dict(import_rem({k: v.numpy() for k, v in rem_init.items()}, jrem_cfg))
    for k, v in unstack_prog_params(stacked).items():
        assert k in merged or k.startswith("post_latent"), k
        merged[k] = v
    want = from_jax_params(merged, rem_cfg)
    assert ours.keys() == want.keys()
    for k in want:
        assert torch.equal(ours[k], want[k]), k


def test_transplant_refuses_wrong_keys(base_state, rem_cfg):
    rem = profile_codec.seeded_model(rem_cfg, "cpu", 1)
    with pytest.raises(ValueError, match="unexpected"):
        rem_demo.transplant({**base_state, "stray.weight": torch.zeros(1)}, rem)
    short = {k: v for k, v in base_state.items() if not k.startswith("g_s.")}
    with pytest.raises(ValueError, match="missing"):
        rem_demo.transplant(short, rem)


def test_bank_steps_move_only_the_banks(base_state, rem_cfg):
    rem = profile_codec.seeded_model(rem_cfg, "cpu", 1)
    rem_demo.transplant(base_state, rem)
    before = {n: p.detach().clone() for n, p in rem.named_parameters()}
    loader = PatchLoader(NaturalSyntheticDataset(n=8, size=96), 2, 64, seed=0, workers=1)
    losses, moved = rem_demo.train_banks(rem, loader, 2, rem_demo.MID_QS, 1e-4, 20)
    assert len(losses) == 2 and np.isfinite(losses).all()
    changed = {n for n, p in rem.named_parameters() if not torch.equal(p, before[n])}
    assert changed and all(n.startswith(BANKS) for n in changed) and len(changed) == moved


@pytest.fixture
def setup_checkpoint(base_state, tmp_path):
    model = get_model(BASE, device="cpu")
    model.load_state_dict(base_state, strict=True)
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), init_train_state(model, TrainConfig()), BASE, TrainConfig())
    return path


def test_rem_flagship_main_on_cpu(setup_checkpoint, tmp_path, monkeypatch):
    monkeypatch.setattr(rem_flagship, "SyntheticKodak", SmallKodak)
    out = tmp_path / "rem_flagship.json"
    res = rem_flagship.main(["--checkpoint", str(setup_checkpoint), "--bank-steps", "2",
                             "--batch-size", "2", "--patch-size", "64", "--n-images", "1",
                             "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["identity_at_init"] and res["frozen_unchanged"] and res["bank_tensors_moved"] > 0
    for k in rem_flagship.RD_KEYS:
        assert res["frozen_base"][k] == res["rem_before_bank_training"][k]
    jax_keys = set(json.loads((REPO / "runs" / "rem_flagship.json").read_text()))
    assert jax_keys <= set(res)


def test_rem_demo_main_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REM_DEMO_BASE_STEPS", "2")
    monkeypatch.setenv("REM_DEMO_BANK_STEPS", "2")
    out = tmp_path / "rem_demo.json"
    res = rem_demo.main(["--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["protocol"]["base_steps"] == 2 and res["protocol"]["bank_steps"] == 2
    assert res["identity_at_init"] and res["bank_tensors_moved"] > 0
    assert res["base"] == res["rem_before_bank_training"]
    jax_keys = set(json.loads((REPO / "runs" / "rem_demo.json").read_text()))
    assert jax_keys <= set(res)
