"""The program's own spans and counters in the traced sub-window.

The port records a span (`progressivecodec_tpu_torch/utils/profiling.py`)
around each public codec call (`codec:*`), model fragment (`frag:*`), coder
phase (`coder:*`), step of the codec's own (`glue:*`) and point where the
host waits on the card (`sync:*`), while a profiler records: in the traced
sub-window only.  Each span carries its id, its parent's id, its name, its
host start and end in Unix-epoch ns (the profiler's clock) and the
counters added while it was the innermost open span.  A span belongs to
the traced requests when its midpoint lies in one of the profiler's
`request` ranges.  A program without the recorder gives None.
"""

from __future__ import annotations

import bisect

REQUEST = "request"


def requests(run) -> list:
    """The traced requests' [start, end] ns, in order."""
    return sorted((a, b) for a, b, name in run["charged"]["ranges"] if name == REQUEST)


def traced(run):
    """The program's spans inside the traced requests, or None."""
    if "charged" not in run or not run.get("profiled"):
        return None
    try:
        from progressivecodec_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    reqs = requests(run)
    starts = [a for a, _ in reqs]
    out = []
    for s in read():
        mid = (s.t0_ns + s.t1_ns) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= reqs[k][1]:
            out.append(s)
    return out or None


def per_image_ms(run, ns: float) -> float:
    return 1e-6 * ns / (len(run["profiled"]) * run["batch"])


def self_ns(spans) -> dict:
    """{id: the span's duration less its children's}."""
    out = {s.id: s.t1_ns - s.t0_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.t1_ns - s.t0_ns
    return out


def outermost(spans, prefix: str) -> list:
    """The spans named `prefix...` that no span of that prefix holds."""
    by_id = {s.id: s for s in spans}
    keep = []
    for s in spans:
        if not s.name.startswith(prefix):
            continue
        p = by_id.get(s.parent)
        while p is not None and not p.name.startswith(prefix):
            p = by_id.get(p.parent)
        if p is None:
            keep.append(s)
    return keep


def descendants(spans, root) -> list:
    """The spans that `root` holds, at any depth."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], [root.id]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c.id)
    return out


def _merge(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _subtract(base, cut) -> list:
    """Merged intervals `base` less merged intervals `cut`."""
    out, j = [], 0
    for a, b in base:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k, lo = j, a
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > lo:
                out.append([lo, cut[k][0]])
            lo = max(lo, cut[k][1])
            k += 1
        if lo < b:
            out.append([lo, b])
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def idle_split(reqs, busy, spans) -> tuple:
    """(idle ns inside the requests, the part of it whose innermost open
    span is a `codec:*` span or none).  `busy`: the merged device-busy
    intervals; a span's own intervals are its interval less its children's,
    so at every instant the innermost open span is the one whose own
    intervals hold it."""
    idle = _subtract(_merge(reqs), _merge(busy))
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append([s.t0_ns, s.t1_ns])
    named = []
    for s in spans:
        if not s.name.startswith("codec:"):
            named += _subtract([[s.t0_ns, s.t1_ns]], _merge(kids.get(s.id, [])))
    unnamed = _subtract(idle, _merge(named))
    return _length(idle), _length(unnamed)
