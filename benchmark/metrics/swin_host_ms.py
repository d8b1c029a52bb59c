"""Host ms per image in the Swin stages (model fragments): the length of the
program's outermost `swin:*` spans (patch embedding, each block's attention
and MLP, patch merging and splitting, the synthesis's last convolutions) in
the traced requests.  Read beside `transforms_device_ms`: host above device
means the Swin stages are launch-bound.  A program without those spans
gives None."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in _spans.outermost(spans, "swin:"))
    return _spans.per_image_ms(run, ns) if ns > 0 else None
