"""launches.correct: the kernel wrappers' launch counters
(``ops.kernels.launches()``), summed, a correct job."""

from gpubench.metrics_util import launches


def read(run):
    return launches(run, "correct")
