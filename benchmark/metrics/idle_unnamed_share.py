"""The share of the traced requests' device-idle time (the requests' ranges
less the device-busy intervals) during which no program span names what
the host does: the innermost open span is a `codec:*` call or there is
none, in % (device).  None without device intervals (the CPU)."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None or not run["charged"]["intervals"]:
        return None
    idle, unnamed = _spans.idle_split(_spans.requests(run), run["charged"]["intervals"], spans)
    return 100.0 * unnamed / idle if idle > 0 else None
