"""wave_dev_ms.cdna: the decision waves' device time, CUDA events at the
section bounds, ms a job (``wave_dev_ms.cluster``) in the cDNA cell, where it
moves job_device_ms.cdna."""

from gpubench.metrics_util import alias

read = alias("wave_dev_ms.cluster")
