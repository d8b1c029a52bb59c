"""Model registry: configuration name -> model, as `progressivecodec_tpu/models/registry.py`."""

from __future__ import annotations

from progressivecodec_tpu_torch.config import ModelConfig


def get_model(cfg: ModelConfig, device=None):
    """WACNN for "cnn", ChannelProgressiveWACNN for "channel", its REM
    subclass PostRateProcessedNetwork for "rate", STF, the
    SymmetricalTransFormer, for "stf" and TCM, the mixed Transformer-CNN
    codec, for "tcm", on `device` (default `cuda`)."""
    from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
    from progressivecodec_tpu_torch.models.rem import PostRateProcessedNetwork
    from progressivecodec_tpu_torch.models.stf import SymmetricalTransFormer
    from progressivecodec_tpu_torch.models.tcm import TCM
    from progressivecodec_tpu_torch.models.wacnn import WACNN

    if cfg.name == "cnn":
        return WACNN(cfg, device=device)
    if cfg.name == "channel":
        return ChannelProgressiveWACNN(cfg, device=device)
    if cfg.name == "rate":
        return PostRateProcessedNetwork(cfg, device=device)
    if cfg.name == "stf":
        return SymmetricalTransFormer(cfg, device=device)
    if cfg.name == "tcm":
        return TCM(cfg, device=device)
    raise KeyError(f"unknown model {cfg.name!r} (have: cnn, channel, rate, stf, tcm)")
