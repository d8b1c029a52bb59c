"""Share of the traced sub-window's wall time in which no kernel, copy or
fill ran on the device, in %."""


def read(run):
    if "charged" not in run or run["window_s"] <= 0 or run["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
