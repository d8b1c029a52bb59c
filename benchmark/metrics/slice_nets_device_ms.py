"""Device ms per image of the slice networks: hyper encoder and decoders, the ChARM base loop, the enhancement and REM's banks (model fragments), charged by
launch to the fragments the configuration file lists under "slice_nets"."""

from benchmark.metrics import _device_ms as _mod


def read(run):
    if "fragments" not in run:
        return None
    return _mod.per_image_ms(run, [f"frag:{n}" for n in run["fragments"]["slice_nets"]])
