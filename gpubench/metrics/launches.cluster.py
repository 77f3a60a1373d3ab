"""launches.cluster: the kernel wrappers' launch counters
(``ops.kernels.launches()``), summed, a cluster job."""

from gpubench.metrics_util import launches


def read(run):
    return launches(run, "cluster")
