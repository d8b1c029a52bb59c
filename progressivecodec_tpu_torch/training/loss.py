"""Rate-distortion losses on the port's channel-last outputs.

Counterpart of `progressivecodec_tpu/training/loss.py`, entry point for
entry point.  The scalable loss keeps the reference's bpp accounting:
bpp = scalable + base + L * hyper, where L is the number of reconstruction
levels, and distortion = 255^2 * mean(lmbda_list * per-level MSE).
"""

from __future__ import annotations

import math

import torch


def _denom(target_shape) -> float:
    b, h, w = target_shape[0], target_shape[1], target_shape[2]
    return -math.log(2) * (b * h * w)


def _bits(lik: torch.Tensor, denom: float) -> torch.Tensor:
    return torch.sum(torch.log(lik)) / denom


def scalable_rate_distortion_loss(output: dict, target: torch.Tensor, lmbda_list) -> dict:
    """output: the multi-quality forward's (x_hat stacked (L, B, H, W, 3),
    likelihoods y / y_prog / z); target (B, H, W, 3)."""
    denom = _denom(target.shape)
    lmbda = torch.as_tensor(lmbda_list, dtype=torch.float32, device=target.device)
    x_hat = output["x_hat"]
    levels = x_hat.shape[0]
    mse = torch.mean((target[None] - x_hat) ** 2, dim=(1, 2, 3, 4))  # (levels,)
    lik = output["likelihoods"]
    bpp_hyper = _bits(lik["z"], denom)
    bpp_base = _bits(lik["y"], denom)
    bpp_scalable = _bits(lik["y_prog"], denom) if "y_prog" in lik else 0.0
    bpp_loss = bpp_scalable + bpp_base + levels * bpp_hyper
    loss = bpp_loss + (255.0**2) * torch.mean(lmbda * mse)
    return {"loss": loss, "bpp_loss": bpp_loss, "bpp_base": bpp_base,
            "bpp_scalable": bpp_scalable, "bpp_hyper": bpp_hyper, "mse": mse}


def rate_distortion_loss(output: dict, target: torch.Tensor, lmbda: float) -> dict:
    """Single-rate RD loss (the WACNN anchor)."""
    denom = _denom(target.shape)
    bpp = sum(_bits(lik, denom) for lik in output["likelihoods"].values())
    mse = torch.mean((output["x_hat"] - target) ** 2)
    return {"loss": lmbda * (255.0**2) * mse + bpp, "bpp_loss": bpp, "mse": mse}


def distortion_loss(output: dict, target: torch.Tensor) -> dict:
    """MSE only (decoder fine-tuning); a stacked x_hat is compared level by level."""
    x_hat = output["x_hat"]
    ref = target[None] if x_hat.ndim == target.ndim + 1 else target
    mse = torch.mean((ref - x_hat) ** 2)
    return {"loss": (255.0**2) * mse, "mse": mse}


def latent_loss(y_hat: torch.Tensor, y_ref: torch.Tensor) -> dict:
    """Frobenius latent matching (REM training): mean over the batch of
    ||y_hat - y_ref||."""
    diff = torch.sum((y_hat - y_ref) ** 2, dim=(1, 2, 3))
    return {"loss": torch.mean(torch.sqrt(diff + 1e-12))}


def mask_rate_distortion_loss(output: dict, target: torch.Tensor, lmbda: float) -> dict:
    """Mask training: MSE of the last reconstruction level only, plus the
    scalable bpp with the hyper counted once."""
    denom = _denom(target.shape)
    x_hat = output["x_hat"]
    last = x_hat[-1] if x_hat.ndim == target.ndim + 1 else x_hat
    mse = torch.mean((last - target) ** 2)
    lik = output["likelihoods"]
    bpp_hyper = _bits(lik["z"], denom)
    if "y_prog" in lik:
        bpp_loss = _bits(lik["y_prog"], denom) + bpp_hyper
    else:
        bpp_loss = _bits(lik["y"], denom) * 0.0 + bpp_hyper
    return {"loss": bpp_loss + (255.0**2) * lmbda * mse, "bpp_loss": bpp_loss, "mse": mse}


def _kd_terms(output: dict, target: torch.Tensor, teacher_enh, teacher_base=None) -> dict:
    """Latent distillation MSE against frozen teacher encoders; `teacher_*`
    are callables target -> latent."""
    y_hat = output["y_hat"]
    y_enh = y_hat[1] if isinstance(y_hat, (list, tuple)) else y_hat
    out = {"kd_enh": torch.mean((y_enh - teacher_enh(target)) ** 2)}
    if teacher_base is not None:
        y_base = y_hat[0] if isinstance(y_hat, (list, tuple)) else output["y_base"]
        out["kd_base"] = torch.mean((y_base - teacher_base(target)) ** 2)
    return out


def scalable_distilled_rate_distortion_loss(output: dict, target: torch.Tensor, lmbda_list,
                                            teacher_enh, teacher_base=None,
                                            gamma: float = 0.5) -> dict:
    """The scalable RD loss plus gamma-weighted teacher-latent MSE terms."""
    out = scalable_rate_distortion_loss(output, target, lmbda_list)
    kd = _kd_terms(output, target, teacher_enh, teacher_base)
    out.update(kd)
    loss = out["loss"] + kd["kd_enh"] * (float(lmbda_list[-1]) * gamma)
    if teacher_base is not None:
        loss = loss + kd["kd_base"] * (float(lmbda_list[0]) * gamma)
    out["loss"] = loss
    return out


def distilled_rate_loss(output: dict, target: torch.Tensor, lmbda_list, teacher_enh) -> dict:
    """Rate plus distillation only."""
    out = scalable_rate_distortion_loss(output, target, lmbda_list)
    kd = _kd_terms(output, target, teacher_enh)
    out.update(kd)
    out["loss"] = out["bpp_loss"] + (255.0**2) * float(lmbda_list[-1]) * kd["kd_enh"]
    return out


def scalable_distilled_distortion_loss(output: dict, target: torch.Tensor, lmbda_list,
                                       teacher_enh, teacher_base=None,
                                       gamma: float = 0.5) -> dict:
    """gamma * RD + (1 - gamma) * distillation."""
    out = scalable_rate_distortion_loss(output, target, lmbda_list)
    kd = _kd_terms(output, target, teacher_enh, teacher_base)
    out.update(kd)
    kd_sum = kd["kd_enh"] + kd["kd_base"] if teacher_base is not None else kd["kd_enh"]
    out["loss"] = gamma * out["loss"] + (1 - gamma) * kd_sum
    return out


def rate_loss(output: dict, target_shape, levels: int) -> dict:
    """Rate only: base + levels * hyper (+ scalable)."""
    denom = _denom(target_shape)
    lik = output["likelihoods"]
    bpp = _bits(lik["y"], denom) + levels * _bits(lik["z"], denom)
    if "y_prog" in lik:
        bpp = bpp + _bits(lik["y_prog"], denom)
    return {"loss": bpp, "bpp_loss": bpp}
