# Copied from rattle_tpu/utils/metrics.py, minus its jax.profiler branch.
"""Observability: spans, counters and the progress bar.

The reference has only stderr phase banners and an 80-column progress bar
behind --verbose (utils.cpp:57-75).  This module keeps that UX and adds
structured metrics: ``GLOBAL.span(name)`` adds a block's host seconds to
``GLOBAL.stages[name]`` and ``GLOBAL.add(name, n)`` counts.  Both only ever
accumulate, so a caller takes a job's share as the difference of two
snapshots; ``stages`` and ``counters`` stay the same dicts for the life of
the process (clear them, never rebind them)."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


class _Span:
    """``with GLOBAL.span(name):`` -- see ``Metrics.span``."""

    __slots__ = ("stages", "name", "t0", "rf")

    def __init__(self, stages: Dict[str, float], name: str):
        self.stages, self.name, self.rf = stages, name, None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        # the clock reads inside the range, so the two agree
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stages[self.name] = self.stages.get(self.name, 0.0) + dt
        return False


@dataclass
class Metrics:
    stages: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def span(self, name: str) -> _Span:
        """A context manager that adds the block's seconds on
        ``time.perf_counter`` to ``stages[name]``, always.  While a
        torch.profiler records, the block is also a
        ``torch.profiler.record_function(name)`` range, on the profiler's
        clock beside the device's work, inside the ranges open around it;
        otherwise it makes no profiler call."""
        return _Span(self.stages, name)


GLOBAL = Metrics()


def print_progress(a: int, b: int) -> None:
    """80-column stderr progress bar (utils.cpp:57-75)."""
    progress = a / b if b else 1.0
    width = 80
    pos = int(width * progress)
    bar = "".join("=" if i < pos else (">" if i == pos else " ")
                  for i in range(width))
    endc = "\n" if a == b else "\r"
    print(f"[{bar}] {a}/{b} ({progress * 100.0}%)", file=sys.stderr, end=endc,
          flush=True)
