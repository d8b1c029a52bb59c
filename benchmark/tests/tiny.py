"""A tiny benchmark tree for the CPU tests: the real harness, readers and
references, with the TINY model (N 32, M 64) at 64x64 and short mixes."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import torch

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
TINY_MODEL = {"N": 32, "M": 64, "dim_chunk": 8, "division_dimension": [32, 64],
              "scale_table": {"min": 0.11, "max": 256.0, "levels": 32}}


def make_root(tmp: Path, batch: int = 1, qualities=(0.0, 3.7, 10.0), check_requests: int = 3) -> Path:
    """A checkout-like tree under tmp whose cells run the TINY configurations."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    (tmp / "benchmark" / "traffic").mkdir(parents=True)
    for d in ("metrics", "reference"):
        shutil.copytree(REPO / "benchmark" / d, tmp / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["model"].update(TINY_MODEL)
        conf["codec"]["lanes"] = 64
        (tmp / c["file"]).write_text(json.dumps(conf))
    mix = {"height": 64, "width": 64, "batch": batch, "qualities": list(qualities), "pool": 3, "pool_seed": 5,
           "warmup_qualities": [10.0], "profiled_requests": 2, "check_requests": check_requests,
           "check_span": check_requests}
    for w in bench["workloads"]:
        (tmp / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, workload: str, seed: int = 7, seconds: float = 2.0, trace: bool = False,
        program_factory=harness.Program, logs=None) -> dict:
    log = (lambda m: logs.append(m)) if logs is not None else (lambda m: None)
    torch.set_num_threads(2)
    return harness.run_cell(root, workload, seed, seconds, trace, torch.device("cpu"), 0.0,
                            log=log, program_factory=program_factory)


def tiny_conf(root: Path, config: str) -> dict:
    return copy.deepcopy(json.loads((root / "benchmark" / "configs" / f"{config}.json").read_text()))
