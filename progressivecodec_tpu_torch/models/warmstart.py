"""Warm-starting the progressive model from a non-progressive anchor.

Counterpart of `progressivecodec_tpu/models/warmstart.py`, as state-dict
grafting on the reference's names: a trained WACNN anchor's g_a and g_s
become the progressive model's base encoder and decoder (a second anchor's
g_s may seed the enhancement decoder); its ChARM banks and entropy
bottleneck carry over as they are (and, with two hyperpriors, its hyper
synthesis seeds the base one).  The rest keeps its fresh initialisation:
the single hyperprior is twice the anchor's width.
"""

from __future__ import annotations

# (progressive prefix, anchor prefix) carried from the anchor
_GRAFTS = (
    ("g_a.0.", "g_a."),
    ("g_s.0.", "g_s."),
    ("cc_mean_transforms.", "cc_mean_transforms."),
    ("cc_scale_transforms.", "cc_scale_transforms."),
    ("lrp_transforms.", "lrp_transforms."),
    ("entropy_bottleneck.", "entropy_bottleneck."),
)
_HYPER_GRAFTS = (("h_mean_s.0.", "h_mean_s."), ("h_scale_s.0.", "h_scale_s."))


def _graft(out: dict, source: dict, dst: str, src: str) -> None:
    for k in [k for k in out if k.startswith(dst)]:
        del out[k]
    for k, v in source.items():
        if k.startswith(src):
            out[dst + k[len(src):]] = v


def warmstart_from_anchor(prog_sd: dict, anchor_sd: dict, anchor_enh_sd: dict | None = None,
                          multiple_hyperprior: bool = False) -> dict:
    """A new progressive state dict: `prog_sd` (a fresh
    ChannelProgressiveWACNN's) with the modules of the WACNN anchor
    `anchor_sd` (M = division_dimension[0]) grafted in, and g_s.1 from
    `anchor_enh_sd` when given.  The inputs are not changed."""
    out = dict(prog_sd)
    grafts = _GRAFTS + (_HYPER_GRAFTS if multiple_hyperprior else ())
    for dst, src in grafts:
        _graft(out, anchor_sd, dst, src)
    if anchor_enh_sd is not None:
        _graft(out, anchor_enh_sd, "g_s.1.", "g_s.")
    return out


def check_warmstart_shapes(prog_sd: dict, grafted: dict) -> None:
    """Every entry of the fresh state dict must be in the grafted one, with
    its shape."""
    for k, v in prog_sd.items():
        if k not in grafted:
            raise ValueError(f"warmstart: {k} missing from the grafted state dict")
        if tuple(grafted[k].shape) != tuple(v.shape):
            raise ValueError(f"warmstart shape mismatch at {k}: "
                             f"{tuple(grafted[k].shape)} vs {tuple(v.shape)}")
