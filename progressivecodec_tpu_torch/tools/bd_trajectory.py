"""BD-rate against the epoch, from a training run's metrics.

Counterpart of tools/bd_trajectory.py.  It reads the `metrics.jsonl` of a
run of the port's trainer (`cli/train.py`, whose records carry the keys of
JAX's), takes every periodic entropy-estimate test sweep (`test` records:
the reference's 14-point quality ladder), drops repeated (bpp, psnr) points,
skips sweeps of fewer than 4 distinct points, and computes the BD-rate of
each sweep against the reference's progressive anchor
(`utils/rd.PROGRESSIVE_ANCHOR_*`; the anchor is curve 1, positive means
more bits); where the sweep's PSNR range misses the anchor's, the row says
"n/a (...)" (JAX's tool raises there).  It prints the table and writes it
as JSON to `--out` (default `<run>/bd_trajectory.json`).  The sweeps are entropy-estimate bpp on
synthetic content: the trajectory's slope is the signal, and the absolute
BD-rate against the real-Kodak anchor carries a content offset.  No model
runs, so there is no device.

Usage:
    python -m progressivecodec_tpu_torch.tools.bd_trajectory --run runs/exp1 [--out traj.json]
"""

from __future__ import annotations

import argparse
import json
import os

from progressivecodec_tpu_torch.cli.rd_sweep import bd_rate_vs_fixed_pret


def trajectory(metrics_path: str) -> list[dict]:
    """One row per usable test sweep: epoch, BD-rate %, max bpp, max PSNR,
    points."""
    rows = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if "test" not in rec:
                continue
            pts = sorted(set(zip(rec["test"]["bpp"], rec["test"]["psnr"])))
            if len(pts) < 4:
                continue
            bpp, psnr = [b for b, _ in pts], [q for _, q in pts]
            bd = bd_rate_vs_fixed_pret(bpp, psnr)
            rows.append({
                "epoch": rec["epoch"],
                "bd_rate_pct_vs_anchor": round(bd, 2) if isinstance(bd, float) else bd,
                "max_bpp": round(max(bpp), 4),
                "max_psnr": round(max(psnr), 2),
                "n_points": len(bpp),
            })
    return rows


def table(rows: list[dict]) -> str:
    lines = [f"{'epoch':>6} {'BD-rate%':>9} {'max_bpp':>8} {'max_psnr':>9}"]
    lines += [f"{r['epoch']:>6} {r['bd_rate_pct_vs_anchor']:>9} {r['max_bpp']:>8} "
              f"{r['max_psnr']:>9}" for r in rows]
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", type=str, required=True, help="the directory of metrics.jsonl")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    rows = trajectory(os.path.join(args.run, "metrics.jsonl"))
    out_path = args.out or os.path.join(args.run, "bd_trajectory.json")
    with open(out_path, "w") as f:
        f.write(json.dumps({
            "anchor": "reference fixed_pret progressive (result_list.py:168-204)",
            "note": "entropy-estimate sweeps on synthetic-Kodak; slope is the signal, absolute "
                    "value carries a content offset",
            "rows": rows,
        }, indent=2))
    print(table(rows))
    print("wrote", out_path)
    return rows


if __name__ == "__main__":
    main()
