"""cluster_reads_per_s: the reads of all the window's cluster jobs over the
window's span."""


def read(run):
    if run["mode"] != "cluster":
        return None
    return run["work"] / run["span_s"]
