"""The port loads no JAX: importing every module of `progressivecodec_tpu_torch`
in a fresh interpreter leaves no `jax`, `jaxlib`, `flax`, `optax` or `orbax`
module, and no module of the JAX package, in `sys.modules`.

This complements `test_port_imports_no_jax` in tests/test_torch_port_codec.py,
which reads the import statements: this test also catches an import made
indirectly, through another package, or at run time of a module's body.
"""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "progressivecodec_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax")

SCRIPT = """
import importlib, json, pkgutil, sys
import {package}
names = sorted(m.name for m in pkgutil.walk_packages({package}.__path__, "{package}."))
for name in names:
    importlib.import_module(name)
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""


def test_port_modules_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(package=PACKAGE)], cwd=REPO, check=True,
        capture_output=True, text=True, timeout=300,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    imported = set(result["imported"])
    for must in ("training.step", "training.loss", "training.optim", "training.freeze",
                 "training.checkpoint", "cli.train", "cli.eval", "utils.rd", "models.warmstart",
                 "ops.noise", "coder.rans_cuda", "layers.importance", "layers.postnets",
                 "training.mask_trainer", "cli.rd_sweep", "utils.profiling", "utils.flops",
                 "data.openimages", "parallel.distributed", "parallel.mesh",
                 "parallel.sharded_coder", "parallel.tiling", "parallel.sharding",
                 "tools.bench_coder", "tools.profile_codec", "tools.bench_2k", "tools.rd_ladder",
                 "tools.rem_demo", "tools.rem_flagship", "tools.bd_trajectory",
                 "models.stf", "layers.swin", "models.tcm", "layers.tcm"):
        assert f"{PACKAGE}.{must}" in imported, must
    leaked = [m for m in result["loaded"]
              if m.split(".")[0] in BANNED or m == "progressivecodec_tpu"
              or m.startswith("progressivecodec_tpu.")]
    assert not leaked, leaked
