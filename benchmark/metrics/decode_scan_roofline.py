"""The decode scan kernel's share of its roofline, in % (kernels)."""

from benchmark.metrics import _scan as _mod


def read(run):
    return _mod.roofline(run, "decode")
