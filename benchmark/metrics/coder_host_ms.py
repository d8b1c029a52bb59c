"""Host ms per image in the coder's phases: the own time (the span's less
its children's) of the program's `coder:*` spans in the traced requests
(coder).  Read beside `coder_device_ms`: host above device means the
phases wait on their launches, not on the card."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    own = _spans.self_ns(spans)
    ns = sum(own[s.id] for s in spans if s.name.startswith("coder:"))
    return _spans.per_image_ms(run, ns) if ns > 0 else None
