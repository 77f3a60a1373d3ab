"""job_device_ms.correct: the device's busy ms a correct job (the union of
its kernel, copy and set intervals in the profiler's trace), mean over one
traced job a pool set after the window."""

from gpubench.metrics_util import device_ms


def read(run):
    return device_ms(run, "correct")
