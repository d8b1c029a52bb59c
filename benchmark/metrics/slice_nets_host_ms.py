"""Host ms per image in the slice networks (model fragments): the length of
the program's outermost `frag:*` spans of the fragments the configuration
file lists under "slice_nets", less the `sync:*` spans inside them, where
the host waits on the card.  Read beside `slice_nets_device_ms`: host above
device means the slice networks are launch-bound."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None or "fragments" not in run:
        return None
    names = {f"frag:{n}" for n in run["fragments"]["slice_nets"]}
    ns = 0
    for s in _spans.outermost(spans, "frag:"):
        if s.name in names:
            waits = _spans.outermost(_spans.descendants(spans, s), "sync:")
            ns += (s.t1_ns - s.t0_ns) - sum(w.t1_ns - w.t0_ns for w in waits)
    return _spans.per_image_ms(run, ns) if ns > 0 else None
