"""Host ms per image spent waiting on the card: the length of the program's
outermost `sync:*` spans in the traced requests (codec entry)."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in _spans.outermost(spans, "sync:"))
    return _spans.per_image_ms(run, ns) if ns > 0 else None
