"""Multi-process jobs for the tests of the port's `parallel/` package.

`run_ranks(module, workdir)` starts `world` CPU processes that join one gloo
process group and each call `module.rank_job(rank, world, workdir)`; the
job's return value comes back to the test, one per rank.  The group is
joined through the port's own start-up (`parallel/distributed.py`): a file
store under `workdir` by default (the six test workers of the suite would
collide on TCP ports), or `initialize_from_env` from COORDINATOR_ADDRESS /
PROCESS_COUNT / PROCESS_ID with `init="env"`.  Every process runs torch on
one thread, every collective times out after 60 s, and the job as a whole
after `timeout` seconds.

The job modules import torch and the port only at their top level, so a
rank never loads JAX.  This module is not a test module.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pathlib
import socket
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, workdir, world: int = 2, timeout: float = 240.0,
              init: str = "file") -> list:
    """Run `module.rank_job` on `world` ranks; returns each rank's result,
    in rank order.  Raises with a rank's stderr if any rank fails."""
    workdir = pathlib.Path(workdir)
    base = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]),
                RANK_JOB=module, RANK_WORKDIR=str(workdir), RANK_INIT=init,
                PROCESS_COUNT=str(world))
    if init == "env":
        base["COORDINATOR_ADDRESS"] = f"127.0.0.1:{_free_port()}"
    code = "import torch_port_ranks; torch_port_ranks.rank_main()"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(base, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {module} exited {p.returncode}:\n{err[-4000:]}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def rank_main() -> None:
    from progressivecodec_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    workdir = pathlib.Path(os.environ["RANK_WORKDIR"])
    rank, world = int(os.environ["PROCESS_ID"]), int(os.environ["PROCESS_COUNT"])
    if os.environ["RANK_INIT"] == "env":
        distributed.initialize_from_env("gloo", timeout=COLLECTIVE_TIMEOUT)
    else:
        distributed.init_process_group(f"file://{workdir / 'store'}", world, rank, "gloo",
                                       timeout=COLLECTIVE_TIMEOUT)
    try:
        result = importlib.import_module(os.environ["RANK_JOB"]).rank_job(rank, world, workdir)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax"))
        if loaded:
            raise AssertionError(f"a rank loaded JAX: {loaded[:5]}")
        torch.save(result, workdir / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
