"""Device ms per image of the image transforms g_a and g_s (model fragments), charged by
launch to the fragments the configuration file lists under "transforms"."""

from benchmark.metrics import _device_ms as _mod


def read(run):
    if "fragments" not in run:
        return None
    return _mod.per_image_ms(run, [f"frag:{n}" for n in run["fragments"]["transforms"]])
