"""A scan kernel's share of its roofline: the least time its bytes and
operations need at the card's peaks (benchmark/yardstick.py), over the
kernel's device time in the traced sub-window, in %."""



def roofline(run, which: str):
    if "charged" not in run or "cdf_length" not in run:
        return None
    from benchmark import yardstick

    key = run["scan_kernels"][which]
    t = sum(v for k, v in run["charged"]["kernels"].items() if key in k)
    if t <= 0:
        return None
    bound = 0.0
    for r in run["profiled"]:
        w = yardstick.scan_work(run["cfg"], run["cdf_length"], run["batch"], run["height"],
                                run["width"], r["q"], run["lanes"], r["payload_words"])
        bound += yardstick.bound_seconds(w[f"{which}_bytes"], w[f"{which}_ops"])
    return 100.0 * bound / t
