"""Host ms per image in the slice networks' window attention (model
fragments): the length of the program's outermost `swatten:*` spans (each
slice's SWAtten on its mean and on its scale support, on the encode and the
decode side) in the traced requests.  Read beside `slice_nets_device_ms`:
host above device means the SWAttens are launch-bound.  A program without
those spans gives None."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in _spans.outermost(spans, "swatten:"))
    return _spans.per_image_ms(run, ns) if ns > 0 else None
