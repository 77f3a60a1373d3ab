"""gate_block_ms.cdna: device ms of gate_block's three kernels a traced job
(``gate_block_ms``) in the cDNA cell, where it moves job_device_ms.cdna."""

from gpubench.metrics_util import alias

read = alias("gate_block_ms")
