# Frozen from rattle_tpu_torch/pipeline/profile_cluster.py (device_busy_s, the idle share 1 - busy / wall), busy taken as a union of intervals.
"""Arithmetic on a traced window: the union of device intervals, the idle
share, idle gaps by the span the host was in, and a percentile."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Interval]) -> float:
    """Length of the union of ``intervals``."""
    return sum(b - a for a, b in union(intervals))


def idle_share(busy: float, window: float) -> float:
    """Share of ``window`` in which the device ran nothing."""
    return 1.0 - busy / window


def gaps(window: Interval, busy: Sequence[Interval]) -> List[Interval]:
    """The parts of ``window`` outside the disjoint sorted ``busy``."""
    out, at = [], window[0]
    for a, b in busy:
        a, b = max(a, window[0]), min(b, window[1])
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def gaps_by_span(window: Interval, busy: Sequence[Interval],
                 spans: Sequence[Tuple[str, float, float]],
                 outside: str) -> Dict[str, float]:
    """Idle time of ``window`` by the innermost span (name, start, end) open
    at each gap's midpoint (the latest to start), ``outside`` where none is."""
    out: Dict[str, float] = {}
    for a, b in gaps(window, busy):
        mid = (a + b) / 2
        name, start = outside, -math.inf
        for n, s, e in spans:
            if s <= mid < e and s >= start:
                name, start = n, s
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]
