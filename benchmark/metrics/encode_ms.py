"""Host ms per image of compress + serialize, ending in a device sync, over
the window's requests (codec entry)."""


def read(run):
    reqs = [r for r in run["requests"] if r["ok"]]
    if not reqs:
        return None
    return 1e3 * sum(r["enc_s"] for r in reqs) / (len(reqs) * run["batch"])
