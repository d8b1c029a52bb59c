"""Device ms per image of the coder's flat phases (grids, pre-gather,
compaction, value recovery, escapes), the scan kernels excluded."""

from benchmark.metrics import _device_ms as _mod


def read(run):
    if "coder_phases" not in run:
        return None
    return _mod.per_image_ms(run, [f"coder:{n}" for n in run["coder_phases"]])
