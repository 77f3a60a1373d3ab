"""job_s_p90.cluster: the 90th percentile (nearest rank) of the window's
cluster job walls."""

from gpubench.metrics_util import job_s_p90


def read(run):
    return job_s_p90(run, "cluster")
