"""The port's training CLI end to end on the CPU, at TINY (N=32, M=64,
dim_chunk 8, 32 scale levels), batch 2 on 64x64 synthetic patches:

  * `cli.train --device cpu --synthetic --epochs 2 --steps-per-epoch 2
    --eval-every 1`, then a resume from `ckpt_last` to epoch 3: the
    records of every epoch (train_loss, valid, test with 14 qualities,
    real_codec at 0, 1 and 10), no eval_error, finite losses, the step
    counts 2, 4 and 6, the resumed run's epoch numbering and plateau state,
    and both checkpoints, which load back into a fresh train state;
  * a kill inside the checkpoint swap, simulated by leaving only
    `ckpt_last.old`: the resume and `cli.eval --checkpoint` still load it,
    and a save that finds only `.old` keeps it through a second kill;
  * `--sampled` for one epoch;
  * `cli.eval --checkpoint` on the result: real bpp equal to the trainer's
    last real-codec eval at every quality (same weights, same images);
  * `make_eval_step` gives the likelihood bpp and the PSNR of the eval
    forward on the trained weights, as `entropy_estimate_eval` does;
  * `cli.train` without --device raises when no card is present.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_variants import one_torch_thread  # noqa: F401  (autouse)

from progressivecodec_tpu_torch import config as config_lib
from progressivecodec_tpu_torch.cli import eval as eval_cli
from progressivecodec_tpu_torch.cli import train as train_cli
from progressivecodec_tpu_torch.config import ModelConfig, ScaleTableConfig, TrainConfig
from progressivecodec_tpu_torch.data.datasets import SyntheticDataset
from progressivecodec_tpu_torch.models.codec_granular import make_codec
from progressivecodec_tpu_torch.models.registry import get_model
from progressivecodec_tpu_torch.training.checkpoint import (load_checkpoint, read_checkpoint,
                                                           save_checkpoint)
from progressivecodec_tpu_torch.training.evaluate import entropy_estimate_eval
from progressivecodec_tpu_torch.training.step import init_train_state, make_eval_step

CFG = ModelConfig(name="channel", N=32, M=64, dim_chunk=8, division_dimension=(32, 64),
                  scale_table=ScaleTableConfig(levels=32))
ARGS = ["--device", "cpu", "--synthetic", "--steps-per-epoch", "2", "--eval-every", "1",
        "--batch-size", "2"]


@pytest.fixture(scope="module")
def small_patches():
    """Train on 64x64 patches (TrainConfig's 256 would cost the CPU ~16x)."""
    orig = train_cli.TrainConfig
    train_cli.TrainConfig = lambda: dataclasses.replace(orig(), patch_size=64)
    yield
    train_cli.TrainConfig = orig


def records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def by_epoch(recs, key):
    return {r["epoch"]: r[key] for r in recs if key in r}


@pytest.fixture(scope="module")
def run(tmp_path_factory, small_patches):
    root = tmp_path_factory.mktemp("train")
    cfg_path = root / "tiny.json"
    cfg_path.write_text(config_lib.to_json(CFG))
    out = str(root / "run")
    common = ARGS + ["--config", str(cfg_path), "--out", out]
    train_cli.main(common + ["--epochs", "2"])
    first = records(out)
    train_cli.main(common + ["--epochs", "3", "--checkpoint", os.path.join(out, "ckpt_last")])
    return {"out": out, "common": common, "cfg_path": str(cfg_path), "first": first,
            "all": records(out)}


def test_train_then_resume_records(run):
    recs = run["all"]
    assert not [r for r in recs if "eval_error" in r]
    steps = by_epoch(recs, "step")
    assert steps == {0: 2, 1: 4, 2: 6}
    assert len(run["first"]) < len(recs) and recs[: len(run["first"])] == run["first"]
    for key in ("train_loss", "valid", "test", "real_codec"):
        assert sorted(by_epoch(recs, key)) == [0, 1, 2], key
    assert all(np.isfinite(v) for v in by_epoch(recs, "train_loss").values())
    for epoch, test in by_epoch(recs, "test").items():
        assert len(test["bpp"]) == 14 and np.isfinite(test["bpp"]).all()
    for real in by_epoch(recs, "real_codec").values():
        assert len(real["bpp"]) == 3 and real["n_images"] == 2
        assert np.isfinite(real["bpp"]).all() and real["bpp"][0] < real["bpp"][2]
    valid = by_epoch(recs, "valid")
    assert all(np.isfinite(v["loss"]) for v in valid.values())


def test_checkpoints_hold_the_resumed_state(run):
    out = run["out"]
    for name in ("ckpt_last", "ckpt_best"):
        assert sorted(os.listdir(os.path.join(out, name))) == ["config.json", "state.pt"]
        assert not os.path.exists(os.path.join(out, name + ".old"))
    meta = json.load(open(os.path.join(out, "ckpt_last", "config.json")))
    assert meta["model"] == json.loads(config_lib.to_json(CFG))
    assert meta["train"]["batch_size"] == 2 and meta["train"]["epochs"] == 3
    extra = meta["extra"]
    assert extra["epoch"] == 2
    losses = [v["loss"] for v in by_epoch(run["all"], "valid").values()]
    assert extra["best_loss"] == min(losses)
    assert extra["plateau"]["best"] == min(losses) and extra["plateau"]["scale"] == 1.0
    model = get_model(CFG, device="cpu")
    state, meta2 = load_checkpoint(os.path.join(out, "ckpt_last"), init_train_state(
        model, TrainConfig(batch_size=2)))
    assert state.step == 6 and meta2 == meta
    assert len(state.opt.main.state) == len(state.opt.main_params)
    assert all(int(s["step"]) == 6 for s in state.opt.aux.state.values())


def test_kill_inside_the_swap_leaves_a_loadable_checkpoint(run, tmp_path):
    out = str(tmp_path / "run")
    shutil.copytree(run["out"], out)
    os.rename(os.path.join(out, "ckpt_last"), os.path.join(out, "ckpt_last.old"))
    model = get_model(CFG, device="cpu")
    state, meta = load_checkpoint(os.path.join(out, "ckpt_last"),
                                  init_train_state(model, TrainConfig()))
    assert state.step == 6 and meta["extra"]["epoch"] == 2
    result = eval_cli.main(["--checkpoint", os.path.join(out, "ckpt_last"), "--synthetic",
                            "--max-images", "1", "--qualities", "0", "--device", "cpu"])
    assert np.isfinite(result["real_codec"]["bpp"]).all()


def test_save_after_a_kill_keeps_the_old_checkpoint(run, tmp_path, monkeypatch):
    """A save that finds only `.old` (an earlier save killed between its
    renames) puts it back at the path before writing: a second kill, here
    inside the write, still leaves it loadable, and a finished save
    replaces it and leaves no `.old` or `.saving` behind."""
    path = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(run["out"], "ckpt_last"), path + ".old")
    state, meta = load_checkpoint(path, init_train_state(get_model(CFG, device="cpu"),
                                                         TrainConfig()))
    assert state.step == 6

    def killed(*args, **kwargs):
        raise KeyboardInterrupt("killed inside the write")

    with monkeypatch.context() as m:
        m.setattr(torch, "save", killed)
        with pytest.raises(KeyboardInterrupt):
            save_checkpoint(path, state, CFG, TrainConfig(), meta["extra"])
    assert os.path.isdir(path) and not os.path.exists(path + ".old")
    fresh = init_train_state(get_model(CFG, device="cpu"), TrainConfig())
    assert load_checkpoint(path, fresh)[0].step == 6
    state.step = 7
    save_checkpoint(path, state, CFG, TrainConfig(), meta["extra"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert read_checkpoint(path)[0]["step"] == 7


def test_eval_checkpoint_matches_the_trainer(run):
    result = eval_cli.main(["--checkpoint", os.path.join(run["out"], "ckpt_last"), "--synthetic",
                            "--max-images", "2", "--qualities", "0,1,10", "--device", "cpu"])
    last = by_epoch(run["all"], "real_codec")[2]
    assert result["real_codec"]["bpp"] == last["bpp"]
    assert result["real_codec"]["n_images"] == 2


def test_sampled_training_runs(run, tmp_path):
    out = str(tmp_path / "sampled")
    train_cli.main(ARGS + ["--config", run["cfg_path"], "--out", out, "--epochs", "1",
                           "--sampled", "--eval-every", "5"])
    recs = records(out)
    assert by_epoch(recs, "step") == {0: 2}
    assert np.isfinite(by_epoch(recs, "train_loss")[0])
    assert "test" not in {k for r in recs for k in r}


@pytest.mark.parametrize("q", [0.0, 10.0])
def test_eval_step_matches_the_entropy_estimate(run, q):
    model = get_model(CFG, device="cpu")
    model.load_state_dict(read_checkpoint(os.path.join(run["out"], "ckpt_last"))[0]["model"])
    img = SyntheticDataset(n=1, size=64)[0]
    ours = make_eval_step(q)(model, torch.from_numpy(img)[None])
    est = entropy_estimate_eval(make_codec(model, lanes=64, device="cpu"), [img], pr_list=(q,))
    np.testing.assert_allclose(float(ours["bpp"]), est["bpp"][0], rtol=1e-6)
    np.testing.assert_allclose(float(ours["psnr"]), est["psnr"][0], rtol=1e-5)
    assert ours["x_hat"].shape == (1, 64, 64, 3)


def test_train_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--synthetic", "--out", str(tmp_path)])
