"""Where the time of ``cluster`` goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_cluster [--cdna] [--wall-only]

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED; ``cluster --rna``, or with ``--cdna`` the cDNA
reads of both strands) through the CLI on cuda: once to build and warm up,
WALL_RUNS times plain, for the wall times (median and spread), the peak
device memory and the engine's own phase and section times (host, and on
the card ``*_dev``: each section's device time from CUDA events), then
once under torch.profiler (CPU + CUDA activities) for the device busy
time, the idle share (1 - busy / wall of the profiled run), the CUDA
runtime's kernel launch calls, its synchronising calls (stream syncs and
cudaMemcpyAsync, calls and host seconds) and the device-to-host copies,
the decision waves (``BulkClusterEngine._wave`` calls) and so the copies a
wave, the device time and launches of each of the port's kernels,
lis_filter's launches and device time split by tier and by (M, B, bound
bucket) (``lis_split``), and the top operators by device and by host time.
The last line is one JSON object with these numbers.  ``--wall-only``
stops after the plain runs.

The imports are absolute, so the script also times another checkout of the
package: ``PYTHONPATH=<checkout> python <this file> --wall-only`` run from
that checkout (two commits compared in one call on one card).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
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
# warm unprofiled runs timed after the first
WALL_RUNS = 3


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


# the CUDA runtime calls that make the host wait for the device (a copy to
# or from pageable host memory waits for the copy)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def host_syncs(avgs) -> dict:
    """{name: {calls, s}} of the runtime's synchronising calls in a
    profile's averages (host seconds inside them), and under "DtoH" the
    device-to-host copies the device ran ({calls, device_s})."""
    out = {}
    for a in avgs:
        if a.key in SYNC_CALLS:
            out[a.key] = dict(calls=a.count, s=a.cpu_time_total / 1e6)
        elif a.key.startswith("Memcpy DtoH"):
            d = out.setdefault("DtoH", dict(calls=0, device_s=0.0))
            d["calls"] += a.count
            d["device_s"] += _device_us(a) / 1e6
    return out


def profiled_launches(run) -> dict:
    """Run ``run()`` under torch.profiler.  Returns its wall time, the CUDA
    runtime's kernel launch calls (``launch_calls``, their sum and by
    call), its synchronising calls and device-to-host copies
    (``host_syncs``), the device busy time and the idle share (1 - busy /
    wall)."""
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    calls = launch_calls(avgs)
    busy = device_busy_s(prof)
    return dict(wall_s=wall, launch_calls=sum(calls.values()),
                by_call=calls, syncs=host_syncs(avgs), device_busy_s=busy,
                idle_share=1 - busy / wall)


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


@contextlib.contextmanager
def _timed(names, acc: dict):
    """Count the calls of each BulkClusterEngine method in ``names`` and
    add their host seconds into ``acc[name] = [calls, seconds]`` for the
    duration of the block (``__init__`` builds the sketch and tables,
    ``cluster`` runs the engine, ``_wave`` is one decision wave)."""
    cls = bulk.BulkClusterEngine
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                row = acc.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += time.perf_counter() - t0
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


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
        first = _run(fq, tmp, flags)            # builds the kernels
        torch.cuda.reset_peak_memory_stats()
        metrics.GLOBAL.stages.clear()
        metrics.GLOBAL.counters.clear()
        kernels.reset_launches()
        timed = {}
        with _timed(("__init__", "cluster", "_wave"), timed):
            walls = [_run(fq, tmp, flags) for _ in range(WALL_RUNS)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = {k: v / WALL_RUNS for k, v in metrics.GLOBAL.stages.items()}
        counters = {k: v if k.endswith("_max") else v / WALL_RUNS
                    for k, v in metrics.GLOBAL.counters.items()}
        launches = {k: v // WALL_RUNS for k, v in kernels.launches().items()}
        wall = statistics.median(walls)
        # a run's host seconds: the engine's set-up (sketch, tables), its
        # cluster() (waves and the rest), and the CLI around it
        host = {"engine_init": timed["__init__"][1] / WALL_RUNS,
                "engine_cluster": timed["cluster"][1] / WALL_RUNS,
                "waves": timed["_wave"][1] / WALL_RUNS}
        host["cli_rest"] = sum(walls) / WALL_RUNS - host["engine_init"] \
            - host["engine_cluster"]
        head = dict(device=torch.cuda.get_device_name(0), reads=MAIN_READS,
                    flags=flags, first_wall_s=first, walls_s=walls,
                    wall_s=wall, peak_mem_gib=peak, host_split_s=host)
        if "--wall-only" in sys.argv[1:]:
            print(json.dumps(head))
            return 0
        walls_p, waves = [], {}
        with _timed(("_wave",), waves):
            split, prof, _ = lis_split(
                lambda: walls_p.append(_run(fq, tmp, flags)))
        wall_prof = walls_p[0]
        n_waves = waves["_wave"][0]
    n_events = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_s = device_busy_s(prof)
    avgs = prof.key_averages()
    calls = launch_calls(avgs)
    syncs = host_syncs(avgs)
    d2h = syncs.get("DtoH", {}).get("calls", 0)
    by_dev = sorted(avgs, key=_device_us, reverse=True)[:12]
    # the port's own kernels, by their names in csrc/*.cu (gate_block's
    # side kernel and two passes; absorb_rest's two layouts, or the one
    # kernel of an earlier checkout)
    several = {"gate_block": ("gate_sides", "gate_tile", "gate_emit"),
               "absorb_rest": ("absorb_rest", "absorb_panel", "absorb_column")}
    names = {k: several.get(k, (k,)) for k in launches}
    kernel_ms = {name: sum(_device_us(a) for a in avgs
                           if any(f"{n}_kernel" in a.key for n in ns)) / 1e3
                 for name, ns in names.items()}
    by_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                    reverse=True)[:12]
    print(f"{torch.cuda.get_device_name(0)}: {MAIN_READS} reads, cluster "
          f"{' '.join(flags) or '(cDNA)'} {wall:.3f} s unprofiled (median of "
          f"{[round(x, 3) for x in walls]}), {wall_prof:.3f} s profiled; "
          f"peak {peak:.3f} GiB; device busy {busy_s:.3f} s ({n_events} "
          f"device events), idle share {1 - busy_s / wall_prof:.3f}; "
          f"{sum(calls.values())} CUDA launch calls {calls}; host split of a "
          "plain run (s): " + ", ".join(f"{k}={v:.4f}" for k, v in
                                        host.items()))
    print(f"synchronising calls {syncs}; {n_waves} waves, "
          f"{d2h / max(1, n_waves):.2f} device-to-host copies a wave; "
          "engine counters " + ", ".join(
              f"{k[8:]}={v:g}" for k, v in sorted(counters.items())
              if k.startswith("cluster.")))
    print("kernels' device time (ms): " + ", ".join(
        f"{k}={v:.1f} ({launches[k]} launches)" for k, v in kernel_ms.items()))
    print_split("profiled run:", split)
    print("engine phases (s, mean of the plain runs): " + ", ".join(
        f"{k}={v:.4f}" for k, v in sorted(stages.items())))
    print("top device time (self, ms / calls):")
    for a in by_dev:
        print(f"  {_device_us(a) / 1e3:10.1f} {a.count:8d}  {a.key[:70]}")
    print("top host time (self, ms / calls):")
    for a in by_cpu:
        print(f"  {a.self_cpu_time_total / 1e3:10.1f} {a.count:8d}  "
              f"{a.key[:70]}")
    print(json.dumps(dict(
        head, wall_profiled_s=wall_prof, device_busy_s=busy_s,
        idle_share=1 - busy_s / wall_prof, stages_s=stages,
        counters=counters, launch_calls=sum(calls.values()),
        launch_calls_by_call=calls, syncs=syncs, waves=n_waves,
        d2h_a_wave=d2h / max(1, n_waves), launches=launches,
        kernel_device_ms=kernel_ms, lis_split=split)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
