"""gate_block_ms: device ms of gate_block's three kernels (the side kernel,
pass 1, pass 2) a traced job (profiler kernel events)."""

from gpubench.metrics_util import kernel_ms


def read(run):
    return kernel_ms(run, ("gate_sides_kernel", "gate_tile_kernel",
                           "gate_emit_kernel"))
