"""Host ms per image in TCM's blocks (model fragments): the length of the
program's outermost `tcm:*` spans (each ConvTransBlock, each residual block
with stride or upsampling, g_s's last sub-pixel convolution) in the traced
requests, the hyperprior's blocks included.  Read beside
`transforms_device_ms`: host above device means the blocks are
launch-bound.  A program without those spans gives None."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in _spans.outermost(spans, "tcm:"))
    return _spans.per_image_ms(run, ns) if ns > 0 else None
