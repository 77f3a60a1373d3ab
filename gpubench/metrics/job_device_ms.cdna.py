"""job_device_ms.cdna: the device's busy ms a cluster job of the cDNA cell
(the union of its kernel, copy and set intervals in the profiler's trace),
mean over one traced job a pool set after the window."""

from gpubench.metrics_util import device_ms


def read(run):
    return device_ms(run, "cluster")
