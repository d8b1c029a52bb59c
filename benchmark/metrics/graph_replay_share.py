"""The CUDA graphs' share of the unrolled enhancement's units in the traced
requests: 100 x the program's `graph:replay` counts over its `graph:replay`
+ `graph:eager` counts, in % (model fragments).  A unit is one slice's
parameter networks, refinement bank or reconstruction tail in the codec's
unrolled loop; a program without the counters, or requests that run no
such unit, give None."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    replay = sum(s.counts.get("graph:replay", 0) for s in spans)
    eager = sum(s.counts.get("graph:eager", 0) for s in spans)
    return 100.0 * replay / (replay + eager) if replay + eager > 0 else None
