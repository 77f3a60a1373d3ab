"""Where the time of ``cluster`` goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_cluster [--cdna] [--wall-only]

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED; ``cluster --rna``, or with ``--cdna`` the cDNA
reads of both strands) through the CLI on cuda twice: once plain, for the
wall time and the engine's own phase and section times, then once under
torch.profiler (CPU + CUDA activities) for the device busy time, the idle
share (1 - busy / wall of the profiled run), the CUDA runtime's kernel
launch calls, the device time and launches of each of the port's kernels
(the score path's join_expand, score_decide and greedy_owner beside
lis_filter and bv_common), lis_filter's launches and device time split by
tier and by (M, B, bound bucket) (``lis_split``), and the top operators by
device and by host time.  The last line is one JSON object with these
numbers.  ``--wall-only`` runs ``cluster`` WALL_RUNS more times unprofiled
instead (the first run builds the kernels) and prints their wall times and
the peak device memory they allocated.

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

from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline import cli
from rattle_tpu_torch.utils import metrics
from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                          MAIN_SEED, synthetic_reads,
                                          write_fastq)

_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
# warm unprofiled runs that --wall-only times
WALL_RUNS = 4


def _run(fq: str, out: str, flags) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(["cluster", "-i", fq, "-o", out, *flags])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"cluster exited {rc}")
    return time.perf_counter() - t0


def _device_us(avg) -> float:
    # the attribute was self_cuda_time_total before torch 2.4
    return float(getattr(avg, "self_device_time_total",
                         getattr(avg, "self_cuda_time_total", 0.0)))


def launch_calls(avgs) -> dict:
    """{name: calls} of the CUDA runtime's kernel launch functions
    (cudaLaunchKernel, cudaLaunchKernelExC, ...) in a profile's averages."""
    return {a.key: a.count for a in avgs if a.key.startswith("cudaLaunch")}


def device_busy_s(prof) -> float:
    """Seconds of device activity (kernels, copies, sets) in a profile."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6


def profiled_launches(run) -> dict:
    """Run ``run()`` under torch.profiler.  Returns its wall time, the CUDA
    runtime's kernel launch calls (``launch_calls``, their sum and by
    call), the device busy time and the idle share (1 - busy / wall)."""
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = launch_calls(prof.key_averages())
    busy = device_busy_s(prof)
    return dict(wall_s=wall, launch_calls=sum(calls.values()),
                by_call=calls, device_busy_s=busy, idle_share=1 - busy / wall)


def lis_split(run, keep: bool = False):
    """Run ``run()`` under torch.profiler and split lis_filter's launches and
    device time by tier M and by (M, B, bound bucket), the buckets being
    powers of two.  Meanwhile the engine's lis_filter is passed through to
    keep each launch's shape and bound tensor (no copy, no sync); after the
    run the profiler's lis_filter kernels, in launch order, give each launch
    its device time.  With ``keep`` the inputs of the largest chunk of each
    tier are copied and kept too.  Returns (split, profiler, kept), split
    being {"tiers": {M: {launches, ms}}, "shapes": {"M=.. B=.. bound<=..":
    {launches, ms}}} with the shapes of most device time first, and kept
    {M: [p1, p2, valid, bound]}."""
    calls, kept = [], {}

    def through(p1, p2, valid, kmer_size, hc_max_dist, bound):
        n = kernels.lis_filter.launches
        out = kernels.lis_filter(p1, p2, valid, kmer_size, hc_max_dist,
                                 bound=bound)
        if kernels.lis_filter.launches > n:
            b, m = p1.shape
            calls.append((m, b, bound))
            if keep and b > kept.get(m, (0, None))[0]:
                kept[m] = (b, [x.clone() for x in (p1, p2, valid, bound)])
        return out

    saved, bulk.lis_filter = bulk.lis_filter, through
    try:
        with torch.profiler.profile(activities=_ACTIVITIES) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        bulk.lis_filter = saved
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "lis_filter_kernel" in e.name),
                key=lambda e: e.time_range.start)
    if len(ev) != len(calls):
        raise RuntimeError(f"lis_split: {len(calls)} launches but "
                           f"{len(ev)} lis_filter kernels in the trace")
    bounds = (torch.cat([bd.reshape(1) for _m, _b, bd in calls]).tolist()
              if calls else [])
    tiers, shapes = {}, {}
    for (m, b, _bd), bd, e in zip(calls, bounds, ev):
        ms = e.time_range.elapsed_us() / 1e3
        bucket = 1 << max(0, bd - 1).bit_length() if bd > 0 else 0
        for table, key in ((tiers, m),
                           (shapes, f"M={m} B={b} bound<={bucket}")):
            row = table.setdefault(key, dict(launches=0, ms=0.0))
            row["launches"] += 1
            row["ms"] += ms
    split = dict(tiers=dict(sorted(tiers.items())), shapes=dict(sorted(
        shapes.items(), key=lambda kv: -kv[1]["ms"])))
    return split, prof, {m: args for m, (_b, args) in sorted(kept.items())}


def print_split(label: str, split: dict) -> None:
    tiers = ", ".join(f"M={m}: {r['launches']} launches {r['ms']:.2f} ms"
                      for m, r in split["tiers"].items())
    print(f"  {label} lis_filter device time by tier: {tiers}")
    top = "; ".join(f"{k}: {r['launches']} x, {r['ms']:.2f} ms"
                    for k, r in list(split["shapes"].items())[:8])
    print(f"  {label} lis_filter by shape (most device time first): {top}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_cluster needs a CUDA card", file=sys.stderr)
        return 2
    cdna = "--cdna" in sys.argv[1:]
    flags = [] if cdna else ["--rna"]
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED,
                                    revcomp=cdna), fq)
        metrics.GLOBAL.stages.clear()
        kernels.reset_launches()
        wall = _run(fq, tmp, flags)
        if "--wall-only" in sys.argv[1:]:
            torch.cuda.reset_peak_memory_stats()
            walls = [_run(fq, tmp, flags) for _ in range(WALL_RUNS)]
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "reads": MAIN_READS,
                "flags": flags, "first_wall_s": wall, "walls_s": walls,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
            return 0
        stages = dict(metrics.GLOBAL.stages)
        launches = kernels.launches()
        walls = []
        split, prof, _ = lis_split(
            lambda: walls.append(_run(fq, tmp, flags)))
        wall_prof = walls[0]
    n_events = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_s = device_busy_s(prof)
    avgs = prof.key_averages()
    calls = launch_calls(avgs)
    by_dev = sorted(avgs, key=_device_us, reverse=True)[:12]
    # the port's own kernels, by their names in csrc/*.cu
    kernel_ms = {name: sum(_device_us(a) for a in avgs
                           if f"{name}_kernel" in a.key) / 1e3
                 for name in launches}
    by_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                    reverse=True)[:12]
    print(f"{torch.cuda.get_device_name(0)}: {MAIN_READS} reads, cluster "
          f"{' '.join(flags) or '(cDNA)'} {wall:.3f} s unprofiled, "
          f"{wall_prof:.3f} s profiled; device busy "
          f"{busy_s:.3f} s ({n_events} device events), idle share "
          f"{1 - busy_s / wall_prof:.3f}; {sum(calls.values())} CUDA launch "
          f"calls {calls}")
    print("kernels' device time (ms): " + ", ".join(
        f"{k}={v:.1f} ({launches[k]} launches)" for k, v in kernel_ms.items()))
    print_split("profiled run:", split)
    print("engine phases (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(stages.items())))
    print("top device time (self, ms / calls):")
    for a in by_dev:
        print(f"  {_device_us(a) / 1e3:10.1f} {a.count:8d}  {a.key[:70]}")
    print("top host time (self, ms / calls):")
    for a in by_cpu:
        print(f"  {a.self_cpu_time_total / 1e3:10.1f} {a.count:8d}  "
              f"{a.key[:70]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "reads": MAIN_READS,
        "flags": flags, "wall_s": wall, "wall_profiled_s": wall_prof, "device_busy_s": busy_s,
        "idle_share": 1 - busy_s / wall_prof, "stages_s": stages,
        "launch_calls": sum(calls.values()), "launch_calls_by_call": calls,
        "launches": launches, "kernel_device_ms": kernel_ms,
        "lis_split": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
