"""Helpers the metric readers share."""

from gpubench import trace


def alias(name: str):
    """The reader of ``metrics/<name>.py``, for a metric that reads the same
    quantity under a name of its own in cells whose end-to-end metrics
    differ."""
    from gpubench.harness import reader
    return reader(name)


def kernel_ms(run, names) -> "float | None":
    """Mean device ms a traced job of the kernels whose names contain one of
    ``names``; None where no traced job ran one."""
    per = [sum(b - a for n, a, b in r["device"] if any(k in n for k in names))
           for r in run["traced"]]
    if not any(per):
        return None
    return 1e3 * sum(per) / len(per)


def idle_share(run, mode: str) -> "float | None":
    """% of the traced jobs' windows in which the device ran nothing (1 -
    the union of kernel, copy and set intervals / the windows); None
    outside ``mode`` or where no traced job touched the device."""
    recs = [r for r in run["traced"] if r["device"]]
    if run["mode"] != mode or not recs:
        return None
    busy = sum(trace.covered((a, b) for _n, a, b in r["device"])
               for r in recs)
    window = sum(r["window"][1] - r["window"][0] for r in recs)
    return 100.0 * trace.idle_share(busy, window)


def job_s_p90(run, mode: str) -> "float | None":
    """The 90th percentile (nearest rank) of the window's job walls; None
    outside ``mode``."""
    if run["mode"] != mode or not run["jobs"]:
        return None
    return trace.percentile([j["wall_s"] for j in run["jobs"]], 90)


def launches(run, mode: str) -> "float | None":
    """The kernel wrappers' launch counters (``ops.kernels.launches()``),
    summed, a job; None outside ``mode`` or where nothing launched."""
    if run["mode"] != mode or not run["jobs"]:
        return None
    per = [sum(j["launches"].values()) for j in run["jobs"]]
    if not any(per):
        return None
    return sum(per) / len(per)


def device_ms(run, mode: str) -> "float | None":
    """The device's busy ms a traced job (the union of its kernel, copy and
    set intervals), mean over the traced jobs; None outside ``mode`` or
    where no traced job touched the device."""
    recs = [r for r in run["traced"] if r["device"]]
    if run["mode"] != mode or not recs:
        return None
    busy = [trace.covered((a, b) for _n, a, b in r["device"]) for r in recs]
    return 1e3 * sum(busy) / len(busy)
