"""Device ms per image charged to a group of spans in the traced sub-window."""


def per_image_ms(run, names):
    if "charged" not in run or not run["profiled"]:
        return None
    per = run["charged"]["per"]
    s = sum(per[n][0] for n in names if n in per)
    if s <= 0:
        return None
    return 1e3 * s / (len(run["profiled"]) * run["batch"])
