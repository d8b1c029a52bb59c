"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, computed one precision lower than the
configuration states (float32 with TF32 off), that is with TF32 on for
every convolution and product.  Its readings have to exceed a limit.

Beside it, a sound float32 variant of the reference: the same mathematics
with every convolution in the channels-last layout, which cuDNN computes
with other kernels and another order of additions.  With the seeded weights
the ChARM recursion amplifies a latent rounded the other way, so this
variant reads far above the limits, on some requests as far as the control
does: the limits sit below it.  `correct` therefore holds the program to
the reference's order of float32 operations ahead of the quantiser; a
program that reorders them reads like this variant and comes out not
correct (PERF.md, Open questions).

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

runs on the card, at the cell's own size, over the requests a run of each
seed checks, with the plain reference the cell's configuration names, and
prints one JSON line per seed and variant.  The benchmark's runs never run
it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import compare, harness, traffic, weights
from benchmark.reference import coder


@contextlib.contextmanager
def precision(variant: str):
    """"tf32": TF32 on; "channels_last": float32 convolutions in the
    channels-last layout (every reference convolves through
    `torch.nn.functional`); "fp32": the reference as it is."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    conv2d, deconv = F.conv2d, F.conv_transpose2d
    tf32 = variant == "tf32"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    if variant == "channels_last":
        cl = torch.channels_last
        F.conv2d = lambda x, w, *a, **k: conv2d(x.contiguous(memory_format=cl),
                                                w.contiguous(memory_format=cl), *a, **k).contiguous()
        F.conv_transpose2d = lambda x, w, *a, **k: deconv(x.contiguous(memory_format=cl),
                                                          w.contiguous(memory_format=cl), *a, **k).contiguous()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        F.conv2d, F.conv_transpose2d = conv2d, deconv


def readings(ref, conf: dict, mix: dict, seed: int, dev, variants) -> dict:
    """{variant: worst of each number} over the requests a run of `seed`
    checks, each variant of the reference module `ref` in the program's
    place against `ref` as it is."""
    cfg = ref.Cfg(conf["model"])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    P = weights.config_weights(ref, conf, dev)
    pool = traffic.image_pool(mix, dev)
    sched = traffic.Schedule(mix, seed)
    eb = {k.split(".")[-1]: v.cpu().numpy() for k, v in P.items() if "entropy_bottleneck" in k}
    tables = coder.Tables(eb, cfg.scale_table)
    lanes, batch = int(conf["codec"]["lanes"]), int(mix["batch"])
    mask_pol = conf["model"].get("mask_policy", "point-based-std")
    limits = compare.LIMITS
    worst = {v: {k: 0.0 for k in limits} for v in variants}
    for i in sorted(sched.checked):
        idx, q = sched(i)
        x = pool[torch.as_tensor(idx, device=dev)]
        with precision("fp32"):
            r = ref.reference_request(P, cfg, x, q)
        for v in variants:
            with precision(v):
                c = ref.reference_request(P, cfg, x, q)
            stages = [tuple(a.cpu().numpy() for a in s) for s in c["stages"]]
            words, esc = coder.encode(stages, tables, lanes)
            hz, wz = int(mix["height"]) // 64, int(mix["width"]) // 64
            blob = coder.container_blob(words, esc, batch, (hz, wz), lanes, q, mask_pol)
            nums = compare.compare(r, blob, c["x_hat"], c["y_hat"], tables, lanes, batch, q, mask_pol)
            print(json.dumps({"seed": seed, "variant": v, "request": i, "q": q,
                              **{k: nums[k] for k in limits}}), file=sys.stderr, flush=True)
            for k in limits:
                worst[v][k] = max(worst[v][k], nums[k])
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="tf32,channels_last")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    _, _, conf, mix = harness.load_cell(Path.cwd(), args.workload)
    ref = harness.reference(Path.cwd(), conf)
    dev = torch.device("cuda", 0)
    for s in (int(v) for v in args.seeds.split(",")):
        w = readings(ref, conf, mix, s, dev, args.variants.split(","))
        for v, nums in w.items():
            print(json.dumps({"workload": args.workload, "seed": s, "variant": v, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
