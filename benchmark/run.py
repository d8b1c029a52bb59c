"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1
breakdown), then the set-up split and, last, every number compared with
the reference beside its limit; the compared numbers are also the last
lines of standard error.  Exits 2, printing no result, without the CUDA
cards the cell asks for, and 3 when a module of JAX or of the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# every build and kernel cache of the program inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
# one process, few threads: the request loop is one thread of Python and
# dispatch, and idle OpenMP workers spinning beside it only add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    log(f"process age {harness.process_age_s()} s once torch and the harness are imported")
    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no result: cell {args.workload} needs {cell['chips']} CUDA device(s), "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    dev = torch.device("cuda", 0)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), dev,
                           STARTED, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"no result: modules {bad} are loaded (JAX or the JAX package)")
        return 3
    for name, (value, limit) in ((k, v) for k, v in out["checks"].items() if k != "requests"):
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
