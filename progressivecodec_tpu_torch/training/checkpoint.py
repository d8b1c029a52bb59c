"""Checkpoints: model, optimisers and step, with the configuration as JSON.

Counterpart of `progressivecodec_tpu/training/checkpoint.py`, in the port's
own format.  A checkpoint is a directory holding
  state.pt     {"model": state dict, "optimizer": {"main", "aux"} state
               dicts, "step": int}, written by `torch.save` and read back
               with `weights_only=True`;
  config.json  {"model": ModelConfig, "train": TrainConfig, "extra": {...}},
               the JAX package's keys.
CDF tables are never stored: `Codec.update()` rebuilds them from the
weights.  The JAX package's Orbax checkpoints are not read here; export
their parameters with its `save_params_npz` and take them in with
`load_params_npz` and `models.weights.from_jax_params`.

A save is atomic with respect to a kill: it writes `path.saving`, renames
`path` to `path.old` and `path.saving` to `path`, then drops `path.old`.
A kill leaves a complete checkpoint at `path` or at `path.old`, and a load
falls back to `path.old`.  A save that finds only `path.old` renames it
back to `path` before it writes, so a second kill still leaves it.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from progressivecodec_tpu_torch import config as config_lib

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"


def save_checkpoint(path: str, state, model_cfg, train_cfg, extra: dict | None = None) -> None:
    """Write `state` (training/step.TrainState) and the configurations to
    the directory `path`, atomically."""
    path = os.path.abspath(path)
    tmp, old = path + ".saving", path + ".old"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    if os.path.isdir(old):
        if os.path.isdir(path):
            shutil.rmtree(old)
        else:  # a save was killed between its renames: `.old` is the last checkpoint
            os.rename(old, path)
    os.makedirs(tmp)
    payload = {"model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
               "step": int(state.step)}
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    meta = {"model": json.loads(config_lib.to_json(model_cfg)),
            "train": json.loads(config_lib.to_json(train_cfg)),
            "extra": extra or {}}
    with open(os.path.join(tmp, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.isdir(old):
        shutil.rmtree(old)


def _resolve(path: str) -> str:
    """`path`, or `path.old` when only that is left; refuses a directory
    that is no port checkpoint."""
    path = os.path.abspath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        raise NotImplementedError(
            f"{path} holds no {STATE_FILE}: it is not a checkpoint of the port (the JAX "
            "package's Orbax checkpoints are not read; export them with its "
            "save_params_npz and load them with load_params_npz + from_jax_params)"
        )
    return path


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(the saved payload, on the CPU; config.json's contents).  Loading
    it into a model or an optimiser moves each tensor to its parameter's
    device (Adam's step counts stay on the CPU, where Adam keeps them)."""
    path = _resolve(path)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    with open(os.path.join(path, CONFIG_FILE)) as f:
        meta = json.load(f)
    return payload, meta


def load_checkpoint(path: str, state):
    """Restore model, optimisers and step into `state` (from
    init_train_state on the same configuration) -> (state, meta)."""
    payload, meta = read_checkpoint(path)
    state.model.load_state_dict(payload["model"], strict=True)
    state.opt.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, meta


def save_params_npz(path: str, params: dict) -> None:
    """A nested {name: array} tree as a flat .npz ("a/b/c" keys), the JAX
    package's interchange format."""
    flat = {}

    def visit(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                visit(key, v)
            else:
                flat[key] = np.asarray(v)

    visit("", params)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """The nested tree of a `save_params_npz` file, numpy leaves."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree
