"""No module of JAX or of the JAX package in a run: the check compares the
top-level name whole, so the port (`progressivecodec_tpu_torch`) passes and
the JAX package (`progressivecodec_tpu`) does not.  The plain references
import neither JAX, nor the JAX package, nor the port."""

import ast
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


def test_references_import_neither_jax_nor_the_port():
    forbidden = set(harness.FORBIDDEN) | {"progressivecodec_tpu_torch"}
    files = sorted((tiny.REPO / "benchmark" / "reference").glob("*.py"))
    assert {f.stem for f in files} >= {"__init__", "coder", "model"}
    for f in files:  # every import statement, in functions too
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & forbidden, (f.name, names)
    # and nothing they import loads one
    code = ("import importlib.util, pathlib, sys\n"
            f"for f in {[str(f) for f in files]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('reference_' + pathlib.Path(f).stem, f)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not set(ast.literal_eval(r.stdout.strip().splitlines()[-1])) & forbidden
