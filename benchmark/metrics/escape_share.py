"""The escape words' share of the containers' words in the traced
requests: 100 x the program's `words:escape` counts over its
`words:payload` + `words:escape` counts, in % (coder).  An escape codes a
symbol outside its CDF row's support in two raw words."""

from benchmark.metrics import _spans


def read(run):
    spans = _spans.traced(run)
    if spans is None:
        return None
    esc = sum(s.counts.get("words:escape", 0) for s in spans)
    payload = sum(s.counts.get("words:payload", 0) for s in spans)
    return 100.0 * esc / (payload + esc) if payload + esc > 0 else None
