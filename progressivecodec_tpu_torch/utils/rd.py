"""Rate-distortion anchors and RD-curve utilities.

A copy of `progressivecodec_tpu/utils/rd.py`: the reference's published
Kodak anchors (the non-progressive base anchor, its 62-point progressive
curve, two comparison curves and a decode-time anchor), `bd_rate`,
`rd_curve_dict` and `plot_rd`, in numpy (matplotlib only when plotting).
"""

from __future__ import annotations

import numpy as np

# Non-progressive base anchor on Kodak
BASE_ANCHOR_BPP = (0.127, 0.199, 0.309, 0.449, 0.649, 0.895)
BASE_ANCHOR_PSNR = (29.20, 30.59, 32.26, 34.15, 35.91, 37.72)

# The reference's full 62-point progressive curve on Kodak ("fixed_pret"),
# the curve RD sweeps are judged against at every progressive rate point
PROGRESSIVE_ANCHOR_BPP = (
    0.19309, 0.22198, 0.24570, 0.26795, 0.28907, 0.30917, 0.32830, 0.34643,
    0.36367, 0.37986, 0.39477, 0.40902, 0.42282, 0.43603, 0.44874, 0.46098,
    0.47264, 0.48381, 0.49439, 0.50467, 0.51447, 0.52367, 0.53262, 0.54105,
    0.54896, 0.55659, 0.56389, 0.57070, 0.57728, 0.58349, 0.58937, 0.59495,
    0.60026, 0.60525, 0.61003, 0.61460, 0.61891, 0.62285, 0.62656, 0.63010,
    0.63344, 0.63661, 0.63962, 0.64253, 0.64536, 0.64800, 0.65052, 0.65286,
    0.65519, 0.65727, 0.65935, 0.65935, 0.66815, 0.67504, 0.68065, 0.68490,
    0.68815, 0.69048, 0.69217, 0.69321, 0.69377, 0.69395,
)
PROGRESSIVE_ANCHOR_PSNR = (
    30.505, 30.178, 30.489, 30.762, 31.017, 31.257, 31.482, 31.693, 31.894,
    32.082, 32.259, 32.427, 32.589, 32.744, 32.893, 33.034, 33.164, 33.289,
    33.407, 33.519, 33.625, 33.725, 33.820, 33.910, 33.995, 34.075, 34.153,
    34.225, 34.294, 34.359, 34.421, 34.477, 34.533, 34.584, 34.633, 34.680,
    34.724, 34.765, 34.804, 34.840, 34.876, 34.908, 34.939, 34.967, 34.995,
    35.021, 35.046, 35.068, 35.090, 35.111, 35.130, 35.130, 35.211, 35.271,
    35.319, 35.352, 35.376, 35.391, 35.402, 35.408, 35.411, 35.412,
)
PROGRESSIVE_ANCHOR_SAMPLES = tuple(
    zip(PROGRESSIVE_ANCHOR_BPP[::15], PROGRESSIVE_ANCHOR_PSNR[::15])
)

# Comparison anchor tri_planet_23, 21 points
TRI_PLANET_23_BPP = (
    0.19599, 0.21608, 0.23967, 0.26492, 0.29048, 0.31530, 0.33862, 0.3715,
    0.428, 0.4549, 0.503, 0.51, 0.56, 0.61848, 0.62278, 0.62644, 0.62953,
    0.63209, 0.63586, 0.64893, 0.66067,
)
TRI_PLANET_23_PSNR = (
    29.967, 30.246, 30.573, 30.920, 31.261, 31.581, 31.872, 32.405, 33.192,
    33.556, 34.184, 34.32, 34.86, 35.358, 35.388, 35.412, 35.431, 35.446,
    35.466, 35.526, 35.587,
)

# Comparison anchor tri_planet_22, 27 points, ascending bpp
TRI_PLANET_22_BPP = (
    0.37233, 0.38820, 0.40381, 0.41917, 0.43427, 0.44904, 0.46349, 0.47758,
    0.49126, 0.50462, 0.51751, 0.53004, 0.54213, 0.55383, 0.56498, 0.57572,
    0.58595, 0.59569, 0.60498, 0.61369, 0.62196, 0.62974, 0.63699, 0.64376,
    0.64997, 0.65572, 0.66088,
)
TRI_PLANET_22_PSNR = (
    31.437, 31.514, 31.731, 31.942, 32.151, 32.353, 32.551, 32.739, 32.919,
    33.093, 33.262, 33.420, 33.570, 33.714, 33.845, 33.968, 34.084, 34.191,
    34.289, 34.379, 34.462, 34.536, 34.603, 34.664, 34.718, 34.766, 34.807,
)

# decode-time anchor per tri_planet_23 point, seconds per image (the
# fastest entry, 2.30 s, is the conservative comparison)
TRI_PLANET_23_DECODE_TIME_S = (
    2.3025, 2.4261, 2.5524, 2.6627, 2.5524, 2.6627, 2.7726, 2.8762, 2.9079,
    2.9807, 2.9079, 2.9807, 2.9807, 9.1804, 6.9356, 6.2114, 5.8699, 5.6761,
    5.4824, 5.5329, 5.5668,
)
DECODE_TIME_ANCHOR_RANGE_S = (
    min(TRI_PLANET_23_DECODE_TIME_S), max(TRI_PLANET_23_DECODE_TIME_S)
)

# quality grid of the reference's fine-grained progressive sweep
QUALITY_GRID = tuple(round(q * 0.1, 1) for q in range(0, 51)) + tuple(
    round(5.5 + 0.5 * i, 1) for i in range(0, 10)
)


def bd_rate(r1, d1, r2, d2) -> float:
    """Bjontegaard delta-rate of curve 2 vs curve 1 (negative = curve 2
    needs fewer bits at equal quality).  Standard cubic-fit in log-rate."""
    r1, d1 = np.asarray(r1, float), np.asarray(d1, float)
    r2, d2 = np.asarray(r2, float), np.asarray(d2, float)
    lr1, lr2 = np.log(r1), np.log(r2)
    p1 = np.polyfit(d1, lr1, 3)
    p2 = np.polyfit(d2, lr2, 3)
    lo = max(d1.min(), d2.min())
    hi = min(d1.max(), d2.max())
    if hi <= lo:
        raise ValueError("quality ranges do not overlap")
    P1 = np.polyint(p1)
    P2 = np.polyint(p2)
    int1 = np.polyval(P1, hi) - np.polyval(P1, lo)
    int2 = np.polyval(P2, hi) - np.polyval(P2, lo)
    avg_diff = (int2 - int1) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100.0)


def rd_curve_dict(bpp, psnr, label: str) -> dict:
    return {"label": label, "bpp": list(map(float, bpp)), "psnr": list(map(float, psnr))}


def plot_rd(curves: list[dict], path: str, title: str = "RD curve (Kodak)"):
    """Write an RD plot PNG and return its path; without matplotlib, write
    nothing and return None."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(7, 5))
    for c in curves:
        ax.plot(c["bpp"], c["psnr"], marker="o", ms=3, label=c["label"])
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
