"""The comparison that decides `correct`.

For each checked request the plain reference (`benchmark/reference/`)
works out again, from the benchmark's weights and images alone, what the
round trip has to produce, and four numbers are compared, each against its
limit:

  xhat_rel_l2      ||x_hat - x_hat_ref|| / ||x_hat_ref|| over the request's
                   images: the transforms, and everything that feeds them
  yhat_mismatch    share of the decoded latent's elements (the synthesis
                   input) more than YHAT_TOL from the reference's: the
                   entropy parameters, the mask, the CDF rows and the values
                   the coder decoded
  bytes_gap        |container bytes - reference bytes| / reference bytes,
                   the reference's container coded by the NumPy rANS coder
                   from its own symbols, rows and keep flags: the kept set
                   and the coder's output
  z_mismatch       share of the first stage's symbols (z) that the NumPy
                   decoder reads from the program's container, with the
                   reference's tables, unlike the reference's; 1 where the
                   header does not hold the request's batch, quality and
                   lanes: the container as a stream another decoder reads

The later stages are not decoded by the reference: their CDF rows come from
sigma, and a program that computes sigma with another (sound) rounding
would pick another row for a handful of elements, after which an rANS
stream reads as noise.  Their values are judged through `yhat_mismatch`.
The limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import coder

YHAT_TOL = 0.05
LIMITS = {"xhat_rel_l2": 1e-3, "yhat_mismatch": 1e-4, "bytes_gap": 5e-5, "z_mismatch": 5e-6}


def reference_container(ref_out: dict, tables: coder.Tables, lanes: int, mask_pol: str):
    """(bytes, z symbols) of the container the reference's stages make."""
    stages = [tuple(a.cpu().numpy() for a in s) for s in ref_out["stages"]]
    words, esc = coder.encode(stages, tables, lanes)
    return coder.container_bytes(len(words), len(esc), mask_pol), stages[0]


def compare(ref_out: dict, blob: bytes, x_hat, y_hat, tables: coder.Tables, lanes: int,
            batch: int, quality: float, mask_pol: str) -> dict:
    """The four numbers of one request."""
    xr = ref_out["x_hat"].double()
    dx = torch.linalg.vector_norm(x_hat.double() - xr) / torch.linalg.vector_norm(xr).clamp_min(1e-30)
    yr = ref_out["y_hat"]
    if tuple(y_hat.shape) == tuple(yr.shape):
        ymis = float(((y_hat.float() - yr).abs() > YHAT_TOL).double().mean())
    else:
        ymis = 1.0
    ref_bytes, (z_sym, z_rows, z_keep) = reference_container(ref_out, tables, lanes, mask_pol)
    c = coder.parse_container(blob)
    if (c["batch"], c["lanes"], c["quality"]) != (batch, lanes, float(np.float32(quality))):
        zmis = 1.0
    else:
        got = coder.decode_first_stage(c["words"], c["esc"], z_rows, z_keep, tables, lanes)
        zmis = float(np.mean(got != z_sym))
    return {"xhat_rel_l2": float(dx), "yhat_mismatch": ymis,
            "bytes_gap": abs(len(blob) - ref_bytes) / ref_bytes, "z_mismatch": zmis,
            "ref_bytes": ref_bytes}


def verdict(worst: dict, limits: dict) -> bool:
    return all(worst[k] <= limits[k] for k in limits)
