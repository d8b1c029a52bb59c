"""Host ms per image of deserialize + decompress, ending in a device sync,
over the window's requests (codec entry)."""


def read(run):
    reqs = [r for r in run["requests"] if r["ok"]]
    if not reqs:
        return None
    return 1e3 * sum(r["dec_s"] for r in reqs) / (len(reqs) * run["batch"])
