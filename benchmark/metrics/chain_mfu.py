"""The whole round trip's share of the card's float32 peak, in %: the FLOPs
the traced requests need, counted on the plain reference at each request's
shape and quality (benchmark/yardstick.py), over the traced sub-window's
seconds times the peak.  A share at or above 100% raises."""


def read(run):
    if "charged" not in run or not run["profiled"] or run["busy_s"] <= 0:
        return None
    from benchmark import yardstick

    counts: dict = {}
    flops = 0
    for r in run["profiled"]:
        if r["q"] not in counts:
            counts[r["q"]] = yardstick.chain_flops(run["cfg"], run["batch"], run["height"],
                                                   run["width"], r["q"])
        flops += counts[r["q"]]
    peak = yardstick.peak_flops(run["device_kind"])
    return 100.0 * yardstick.gated_share(flops, run["window_s"], peak)
