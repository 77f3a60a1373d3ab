"""Where the time of ``correct`` goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_correct [--wall-only]

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED) through the CLI on cuda, then runs ``correct`` on
it twice: once plain, for the wall time, the peak device memory and the pack
engine's own section times (t_steps_s: the read steps), then once under
torch.profiler (CPU + CUDA activities) for the CUDA runtime's kernel launch
calls, the device busy time, poa_align's share of it and the rest (the
step's other kernels and operators), the idle share (1 - busy / wall of the
profiled run) and the top operators by device and by host time.  The last
line is one JSON object with these numbers.  ``--wall-only`` stops after the
plain run.  The kernels are built first, outside the timed runs.

The imports are absolute, so the script also times another checkout of the
package: ``PYTHONPATH=<checkout> python <this file> --wall-only`` run from
that checkout (two commits compared in one call on one card).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline import cli
from rattle_tpu_torch.pipeline.profile_cluster import (_device_us,
                                                      launch_calls)
from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                          MAIN_SEED, synthetic_reads,
                                          write_fastq)


def _run(argv) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_correct needs a CUDA card", file=sys.stderr)
        return 2
    # every kernel built before the timed runs (nvcc takes seconds a kernel)
    _ext.build(_ext.KERNELS)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED), fq)
        _run(["cluster", "-i", fq, "-o", tmp, "--rna"])
        correct = ["correct", "-i", fq, "-c",
                   os.path.join(tmp, "clusters.out"), "-o", tmp]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall = _run(correct)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stats = dict(runner.LAST_STATS)
        launches = kernels.launches()
        if "--wall-only" in sys.argv[1:]:
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "reads": MAIN_READS,
                "wall_s": wall, "peak_mem_gib": peak_gib, "engine": stats,
                "launches": launches}))
            return 0
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall_prof = _run(correct)
    cuda_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in cuda_events) / 1e6
    avgs = prof.key_averages()
    calls = launch_calls(avgs)
    poa_s = sum(_device_us(a) for a in avgs if "poa_align" in a.key) / 1e6
    by_dev = sorted(avgs, key=_device_us, reverse=True)[:12]
    by_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                    reverse=True)[:12]
    print(f"{torch.cuda.get_device_name(0)}: {MAIN_READS} reads, correct "
          f"{wall:.3f} s unprofiled, {wall_prof:.3f} s profiled; device busy "
          f"{busy_s:.3f} s ({len(cuda_events)} device events), idle share "
          f"{1 - busy_s / wall_prof:.3f}; {sum(calls.values())} CUDA launch "
          f"calls {calls}; poa_align {poa_s:.3f} s, the rest "
          f"{busy_s - poa_s:.3f} s; peak {peak_gib:.3f} GiB")
    print(f"pack engine: {stats}")
    print("top device time (self, ms / calls):")
    for a in by_dev:
        print(f"  {_device_us(a) / 1e3:10.1f} {a.count:8d}  {a.key[:70]}")
    print("top host time (self, ms / calls):")
    for a in by_cpu:
        print(f"  {a.self_cpu_time_total / 1e3:10.1f} {a.count:8d}  "
              f"{a.key[:70]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "reads": MAIN_READS,
        "wall_s": wall, "wall_profiled_s": wall_prof, "device_busy_s": busy_s,
        "idle_share": 1 - busy_s / wall_prof, "launch_calls":
        sum(calls.values()), "launch_calls_by_call": calls,
        "poa_align_device_s": poa_s, "other_device_s": busy_s - poa_s,
        "t_steps_s": stats.get("t_steps_s"), "peak_mem_gib": peak_gib,
        "engine": stats, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
