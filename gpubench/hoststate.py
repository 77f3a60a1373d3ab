"""What the host did around a run's window, for its log on standard error:
the cores the process may use and ran on, the CPU's model and clock, the
process's CPU time and context switches, the machine's busy and stolen
time from /proc/stat, transparent huge pages, the load, a fixed loop's time,
and the card's NUMA node.  It reads /proc and /sys and sets nothing; what a
platform lacks reads "?".  No number here enters a metric.
"""

from __future__ import annotations

import os
import resource
import time
from typing import List


def _read(path: str) -> str:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return ""


def _cpu_now() -> str:
    """The core this process last ran on (field 39 of /proc/self/stat)."""
    stat = _read("/proc/self/stat")
    if not stat:
        return "?"
    return stat.rsplit(")", 1)[1].split()[36]


def _machine_times() -> List[int]:
    """/proc/stat's first line: user nice system idle iowait irq softirq
    steal (jiffies of all cores)."""
    line = _read("/proc/stat").split("\n", 1)[0].split()
    return [int(x) for x in line[1:9]] if line[:1] == ["cpu"] else []


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(t=time.perf_counter(), utime=ru.ru_utime, stime=ru.ru_stime,
                nvcsw=ru.ru_nvcsw, nivcsw=ru.ru_nivcsw, minflt=ru.ru_minflt,
                cpu=_cpu_now(), machine=_machine_times())


def calibrate() -> float:
    """The least of three timings, in ms, of a fixed loop of plain Python:
    a reading of how fast a core runs this process just now."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i % 7
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _cpu_model() -> str:
    model, mhz = "?", []
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("model name") and model == "?":
            model = line.split(":", 1)[1].strip()
        elif line.startswith("cpu MHz"):
            mhz.append(float(line.split(":", 1)[1]))
    clock = f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz else "? MHz"
    return f"{model}, {clock}"


def _huge_pages() -> str:
    for line in _read("/proc/self/smaps_rollup").splitlines():
        if line.startswith("AnonHugePages"):
            return line.split(":", 1)[1].strip()
    return "?"


def describe(h0: dict, h1: dict, jobs: List[dict]) -> str:
    wall = h1["t"] - h0["t"]
    cpu = (h1["utime"] - h0["utime"]) + (h1["stime"] - h0["stime"])
    m0, m1 = h0["machine"], h1["machine"]
    if m0 and m1:
        d = [b - a for a, b in zip(m0, m1)]
        total = sum(d) or 1
        machine = (f"machine busy {100 * (total - d[3] - d[4]) / total:.1f}%"
                   f", steal {100 * d[7] / total:.2f}%")
    else:
        machine = "machine ?"
    try:
        cores = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = []
    job_cpu = sum(j.get("cpu_s", 0.0) for j in jobs)
    job_wall = sum(j["wall_s"] for j in jobs) or 1.0
    load = _read("/proc/loadavg").split()[:3]
    return (f"cores {len(cores)} allowed, ran on {h0['cpu']} -> {h1['cpu']}"
            f" ({_cpu_model()}); window cpu {cpu:.3f} s of {wall:.3f} s, jobs"
            f" cpu/wall {job_cpu / job_wall:.3f}, switches "
            f"{h1['nvcsw'] - h0['nvcsw']} voluntary "
            f"{h1['nivcsw'] - h0['nivcsw']} involuntary, minor faults "
            f"{h1['minflt'] - h0['minflt']}; {machine}; anon huge pages "
            f"{_huge_pages()}; load {' '.join(load) or '?'}; fixed loop "
            f"{calibrate():.2f} ms")


def card(torch) -> str:
    """The card's PCI address, NUMA node and the cores local to it."""
    try:
        p = torch.cuda.get_device_properties(0)
        bus = (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
               f"{p.pci_device_id:02x}.0")
    except (AttributeError, RuntimeError):
        return "pci ?"
    dev = f"/sys/bus/pci/devices/{bus}"
    node = _read(dev + "/numa_node").strip() or "?"
    local = _read(dev + "/local_cpulist").strip() or "?"
    return f"pci {bus}, numa node {node}, local cores {local}"
