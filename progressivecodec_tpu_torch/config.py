"""Typed configuration for the model, the coder and training.

A field-for-field copy of `progressivecodec_tpu/config.py` (ModelConfig,
ScaleTableConfig, CoderConfig, TrainConfig) with the same JSON, so either
package reads the other's configuration files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScaleTableConfig:
    """Exponentially spaced Gaussian scale table (coded streams depend on it)."""

    min: float = 0.11
    max: float = 256.0
    levels: int = 64

    def values(self) -> np.ndarray:
        return np.exp(
            np.linspace(np.log(self.min), np.log(self.max), self.levels)
        ).astype("float64")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs for the progressive codec family."""

    name: str = "channel"  # "cnn" | "channel" | "rate"
    N: int = 192
    M: int = 640
    dim_chunk: int = 32
    division_dimension: tuple[int, int] = (320, 640)
    max_support_slices: int = 5
    multiple_encoder: bool = True
    multiple_decoder: bool = True
    multiple_hyperprior: bool = False
    mask_policy: str = "point-based-std"
    joiner_policy: str = "res"  # res | cond | channel_cond | channel_res
    support_progressive_slices: int = 0
    delta_encode: bool = False
    residual_before_lrp: bool = False
    double_dim: bool = False
    support_std: bool = False
    total_mu_rep: bool = False
    all_scalable: bool = False
    u_net_post: int = 0  # 0 | 1 | 2
    stack_prog: bool = True
    lmbda_list: tuple[float, ...] = (0.0055, 0.04)
    scale_table: ScaleTableConfig = dataclasses.field(default_factory=ScaleTableConfig)
    check_levels: tuple[float, ...] = (0.01, 0.25, 1.75)

    @property
    def num_slices(self) -> int:
        return self.M // self.dim_chunk

    @property
    def division_channel(self) -> int:
        return self.division_dimension[0]

    @property
    def ns0(self) -> int:
        """Number of base slices (first cumulative boundary)."""
        return self.division_dimension[0] // self.dim_chunk

    @property
    def ns1(self) -> int:
        """Total slices through the enhancement layer."""
        return self.division_dimension[1] // self.dim_chunk

    @property
    def num_prog_slices(self) -> int:
        return self.ns1 - self.ns0

    @property
    def delta_dim(self) -> int:
        return self.division_dimension[1] - self.division_dimension[0]

    @property
    def scalable_levels(self) -> int:
        return len(self.lmbda_list)


@dataclasses.dataclass(frozen=True)
class CoderConfig:
    """Entropy-coder constants."""

    precision: int = 16
    bypass_precision: int = 4
    lanes: int = 1024
    tail_mass: float = 1e-9


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training protocol defaults.  `mesh_data` and `mesh_tile` are held
    as JAX holds them and read nowhere, as in JAX: a sharded run builds its
    mesh with `parallel/mesh.make_mesh`."""

    batch_size: int = 16
    patch_size: int = 256
    epochs: int = 150
    lr: float = 1e-4
    aux_lr: float = 1e-3
    clip_max_norm: float = 1.0
    lr_factor: float = 0.3
    lr_patience: int = 8
    seed: int = 42
    sampling_training: bool = False
    num_images: int = 300_000
    num_images_val: int = 816
    mesh_data: int = 1
    mesh_tile: int = 1


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _from_dict(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if k == "scale_table" and isinstance(v, dict):
            v = ScaleTableConfig(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def model_config_from_json(s: str) -> ModelConfig:
    return _from_dict(ModelConfig, json.loads(s))


def train_config_from_json(s: str) -> TrainConfig:
    return _from_dict(TrainConfig, json.loads(s))
