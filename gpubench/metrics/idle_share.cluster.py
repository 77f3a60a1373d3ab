"""idle_share.cluster: % of the traced jobs' windows in which the device ran
nothing (1 - the union of kernel, copy and set intervals / the windows)."""

from gpubench import trace


def read(run):
    if run["mode"] != "cluster":
        return None
    recs = [r for r in run["traced"] if r["device"]]
    if not recs:
        return None
    busy = sum(trace.covered((a, b) for _n, a, b in r["device"])
               for r in recs)
    window = sum(r["window"][1] - r["window"][0] for r in recs)
    return 100.0 * trace.idle_share(busy, window)
