"""join_expand_ms: device ms of join_expand_kernel a traced job (profiler
kernel events)."""

from gpubench.metrics_util import kernel_ms


def read(run):
    return kernel_ms(run, ("join_expand_kernel",))
