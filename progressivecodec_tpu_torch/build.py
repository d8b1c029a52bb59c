"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, at first use, into
`build/kernels/` beside the package (a directory git ignores).  The library
name carries a hash of the source and the flags, so an edited source is
never served by a stale build.  `build()` starts one nvcc per missing
library, all at once, and waits for them; `library(name)` loads one with
`ctypes`.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# kernel library name -> source file under csrc/
SOURCES = {
    "rans_encode": "rans_encode.cu",
    "rans_decode": "rans_decode.cu",
    "deconv": "deconv.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, str]:
    """Build the named kernel libraries (default: all) in parallel.

    Returns {name: ptxas report (registers, spills)}.  Raises RuntimeError
    with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        report = _target(name).with_suffix(".ptxas.txt")
        reports[name] = report.read_text() if report.exists() else ""
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
