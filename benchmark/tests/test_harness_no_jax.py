"""No module of JAX or of the JAX package in a run: the check compares the
top-level name whole, so the port (`progressivecodec_tpu_torch`) passes and
the JAX package (`progressivecodec_tpu`) does not."""

import subprocess
import sys
import types

from benchmark import harness
from benchmark.tests import tiny


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "progressivecodec_tpu_torch_fake", types.ModuleType("x"))
    assert "progressivecodec_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "progressivecodec_tpu.fake", types.ModuleType("y"))
    assert "progressivecodec_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("z"))
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    code = ("import sys, torch; from pathlib import Path; from benchmark.tests import tiny; "
            f"tiny.run(Path({str(root)!r}), 'rem.kodak_b1_finegrid', seconds=0.5, trace=True); "
            "from benchmark import harness; print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
