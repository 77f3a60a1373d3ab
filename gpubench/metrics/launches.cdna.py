"""launches.cdna: the kernel wrappers' launch counters, summed, a job
(``launches.cluster``) in the cDNA cell, where it moves job_device_ms.cdna."""

from gpubench.metrics_util import alias

read = alias("launches.cluster")
