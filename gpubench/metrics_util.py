"""Helpers the metric readers share."""


def kernel_ms(run, names) -> "float | None":
    """Mean device ms a traced job of the kernels whose names contain one of
    ``names``; None where no traced job ran one."""
    per = [sum(b - a for n, a, b in r["device"] if any(k in n for k in names))
           for r in run["traced"]]
    if not any(per):
        return None
    return 1e3 * sum(per) / len(per)
