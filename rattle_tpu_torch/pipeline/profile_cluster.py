"""Where the time of ``cluster`` goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_cluster [--cdna] [--wall-only]
        [--input reads.fq]

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED; ``cluster --rna``, or with ``--cdna`` the cDNA
reads of both strands), or with ``--input`` any read set (a benchmark pool
set written by ``gpubench.modes.cluster.make_inputs``, say), through the
CLI on cuda: once to build and warm up, WALL_RUNS times plain, for the wall
times (median and spread), the peak device memory, the program's own spans
and counters a run (``utils.metrics.GLOBAL``: the host seconds of the
parse, the engine's set-up, phases, waves, sections and fetches, the write,
and on the card each section's device time ``*_dev`` from CUDA events; the
join's pair counts), and from the spans the host split of a run
(``host_split_s``) and the ``List[Cluster]`` builds a run
(``materialize``), then once under torch.profiler (CPU + CUDA activities)
for the device busy time (the union of kernels, copies and sets), the idle
share (1 - busy / wall of the profiled run), the device's idle time split
by the program's spans (each instant of an idle gap to the innermost
program range open then, ``idle_by_span_s``), the CUDA runtime's kernel
launch calls, its synchronising calls (stream syncs and cudaMemcpyAsync,
calls and host seconds) and the device-to-host copies, the decision waves
(``cluster.wave`` ranges) and so the copies a wave, the device time and
launches of each of the port's kernels, lis_filter's launches and device
time split by tier and by (M, B, bound bucket) (``lis_split``), and the top
operators by device and by host time.  The last line is one JSON object
with these numbers.  ``--wall-only`` stops after the plain runs.

The imports are absolute, so the script also times another checkout of the
package: ``PYTHONPATH=<checkout> python <this file> --wall-only`` run from
that checkout (two commits compared in one call on one card; a checkout
without the program's spans reports zeros for them).
"""

from __future__ import annotations

import argparse
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


def device_intervals(prof) -> list:
    """The merged, sorted (start, end) seconds of a profile's device
    activity (kernels, copies, sets; not the device's side of a range)."""
    spans = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy_s(prof) -> float:
    """Seconds of device activity (kernels, copies, sets) in a profile,
    overlapping activities counted once."""
    return sum(b - a for a, b in device_intervals(prof))


def program_ranges(prof, prefix: str = "cluster.") -> list:
    """(name, start, end) seconds of the program's spans in a profile: the
    host's side of each ``utils.metrics.GLOBAL.span`` whose name starts
    with ``prefix``."""
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(prefix)]


def idle_by_span(window, busy, ranges, outside: str = "(no span)") -> dict:
    """{span: seconds} of the device's idle time in ``window`` (start, end),
    ``busy`` being the merged sorted device intervals: each instant of an
    idle gap goes to the innermost of ``ranges`` (name, start, end) open at
    that instant (the one opened last), or to ``outside``."""
    # the window cut into pieces, each labelled with its innermost range
    marks = sorted([(a, 0, i) for i, (_n, a, _b) in enumerate(ranges)]
                   + [(b, 1, i) for i, (_n, _a, b) in enumerate(ranges)])
    pieces, open_, t = [], [], window[0]
    for at, is_end, i in marks:
        at = min(max(at, window[0]), window[1])
        if at > t:
            pieces.append((t, at, ranges[open_[-1]][0] if open_ else outside))
            t = at
        if is_end:
            open_.remove(i)
        else:
            open_.append(i)
    pieces.append((t, window[1], outside))
    # the idle gaps: the window less the busy intervals
    gaps, t = [], window[0]
    for a, b in busy:
        if a >= window[1]:
            break
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < window[1]:
        gaps.append((t, window[1]))
    out: dict = {}
    j = 0
    for ga, gb in gaps:
        while j < len(pieces) and pieces[j][1] <= ga:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < gb:
            pa, pb, name = pieces[k]
            d = min(pb, gb) - max(pa, ga)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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


def host_split(stages: dict, wall: float) -> dict:
    """A run's host seconds by the program's spans (``stages``: a run's
    ``utils.metrics.GLOBAL.stages``): the parse, the engine's set-up, the
    engine's self time outside its waves, the waves, the fetches in them,
    the write, and the rest of ``wall`` (the CLI, id translation)."""
    def g(name):
        return stages.get("cluster." + name, 0.0)
    engine = g("greedy") + g("merge")
    out = {"parse": g("parse"), "engine_setup": g("setup"),
           "engine_host": engine - g("wave"), "waves": g("wave"),
           "fetch": g("fetch"), "write": g("write")}
    out["cli_rest"] = wall - out["parse"] - out["engine_setup"] - engine \
        - out["write"]
    return out


# the range around the profiled job: the window of its idle split
JOB = "profile_cluster/job"


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rattle_tpu_torch.pipeline.profile_cluster")
    ap.add_argument("--cdna", action="store_true",
                    help="cDNA mode (both strands) and, without --input, "
                    "the cDNA main-path reads")
    ap.add_argument("--wall-only", action="store_true",
                    help="stop after the plain runs")
    ap.add_argument("--input", default=None,
                    help="a fastq file to cluster in place of the main-path "
                    "reads")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cluster needs a CUDA card", file=sys.stderr)
        return 2
    flags = [] if args.cdna else ["--rna"]
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        fq = args.input
        if fq is None:
            fq = os.path.join(tmp, "reads.fq")
            write_fastq(synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED,
                                        revcomp=args.cdna), fq)
        with open(fq) as fh:
            n_reads = sum(1 for _ in fh) // 4
        first = _run(fq, tmp, flags)            # builds the kernels
        torch.cuda.reset_peak_memory_stats()
        metrics.GLOBAL.stages.clear()
        metrics.GLOBAL.counters.clear()
        kernels.reset_launches()
        walls = [_run(fq, tmp, flags) for _ in range(WALL_RUNS)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = {k: v / WALL_RUNS for k, v in metrics.GLOBAL.stages.items()}
        counters = {k: v if k.endswith("_max") else v / WALL_RUNS
                    for k, v in metrics.GLOBAL.counters.items()}
        launches = {k: v // WALL_RUNS for k, v in kernels.launches().items()}
        wall = statistics.median(walls)
        host = host_split(stages, sum(walls) / WALL_RUNS)
        head = dict(device=torch.cuda.get_device_name(0), reads=n_reads,
                    input=args.input, flags=flags, first_wall_s=first,
                    walls_s=walls, wall_s=wall, peak_mem_gib=peak,
                    host_split_s=host,
                    materialize=counters.get("cluster.materialize", 0.0))
        if args.wall_only:
            print(json.dumps(head))
            return 0
        walls_p = []

        def job():
            with torch.profiler.record_function(JOB):
                walls_p.append(_run(fq, tmp, flags))
        split, prof, _ = lis_split(job)
        wall_prof = walls_p[0]
    busy = device_intervals(prof)
    busy_s = sum(b - a for a, b in busy)
    ranges = program_ranges(prof)
    window = next((a, b) for n, a, b in program_ranges(prof, JOB)
                  if n == JOB)
    idle = idle_by_span(window, busy, ranges)
    n_waves = sum(1 for n, _a, _b in ranges if n == "cluster.wave")
    span_s: dict = {}
    for n, a, b in ranges:
        span_s[n] = span_s.get(n, 0.0) + b - a
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
    print(f"{torch.cuda.get_device_name(0)}: {n_reads} reads, cluster "
          f"{' '.join(flags) or '(cDNA)'} {wall:.3f} s unprofiled (median of "
          f"{[round(x, 3) for x in walls]}), {wall_prof:.3f} s profiled; "
          f"peak {peak:.3f} GiB; device busy {busy_s:.3f} s, idle share "
          f"{1 - busy_s / wall_prof:.3f}; "
          f"{sum(calls.values())} CUDA launch calls {calls}; host split of a "
          "plain run (s): " + ", ".join(f"{k}={v:.4f}" for k, v in
                                        host.items()))
    print(f"profiled job: idle {window[1] - window[0] - busy_s:.4f} of "
          f"{window[1] - window[0]:.4f} s, by program span (innermost "
          "range open; s): " + ", ".join(f"{k}={v:.4f}"
                                         for k, v in idle.items()))
    print("profiled job's program ranges (s, summed): " + ", ".join(
        f"{k}={v:.4f}" for k, v in sorted(span_s.items())))
    print(f"synchronising calls {syncs}; {n_waves} waves, "
          f"{d2h / max(1, n_waves):.2f} device-to-host copies a wave; "
          "engine counters " + ", ".join(
              f"{k[8:]}={v:g}" for k, v in sorted(counters.items())
              if k.startswith("cluster.")))
    print("kernels' device time (ms): " + ", ".join(
        f"{k}={v:.1f} ({launches[k]} launches)" for k, v in kernel_ms.items()))
    print_split("profiled run:", split)
    print("program spans (s, mean of the plain runs): " + ", ".join(
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
        idle_share=1 - busy_s / wall_prof, idle_by_span_s=idle,
        ranges_s=span_s, stages_s=stages,
        counters=counters, launch_calls=sum(calls.values()),
        launch_calls_by_call=calls, syncs=syncs, waves=n_waves,
        d2h_a_wave=d2h / max(1, n_waves), launches=launches,
        kernel_device_ms=kernel_ms, lis_split=split)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
