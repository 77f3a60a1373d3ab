"""cluster_reads_per_s.cdna: the reads of all the window's cluster jobs over
its span (``cluster_reads_per_s``) in the cDNA cell, per layer there, where
it moves job_device_ms.cdna."""

from gpubench.metrics_util import alias

read = alias("cluster_reads_per_s")
