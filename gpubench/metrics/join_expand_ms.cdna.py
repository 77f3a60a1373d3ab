"""join_expand_ms.cdna: device ms of join_expand_kernel a traced job
(``join_expand_ms``) in the cDNA cell, where it moves job_device_ms.cdna."""

from gpubench.metrics_util import alias

read = alias("join_expand_ms")
