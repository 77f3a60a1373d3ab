"""job_s_p90.cluster: the 90th percentile (nearest rank) of the window's job
walls."""

from gpubench import trace


def read(run):
    if run["mode"] != "cluster" or not run["jobs"]:
        return None
    return trace.percentile([j["wall_s"] for j in run["jobs"]], 90)
