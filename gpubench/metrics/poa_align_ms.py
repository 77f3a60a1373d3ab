"""poa_align_ms: device ms of poa_align_kernel (the pack engine's alignment
of a read step) a traced correct job (profiler kernel events)."""

from gpubench.metrics_util import kernel_ms


def read(run):
    if run["mode"] != "correct":
        return None
    return kernel_ms(run, ("poa_align_kernel",))
