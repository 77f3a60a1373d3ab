# Copied from rattle_tpu/utils/metrics.py, minus its jax.profiler branch.
"""Observability: stage timers, throughput counters, progress bar, profiler.

The reference has only stderr phase banners and an 80-column progress bar
behind --verbose (utils.cpp:57-75).  This module keeps that UX and adds
structured per-stage metrics (reads/s, POA bases/s)."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Metrics:
    stages: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = False):
        if verbose:
            print(f"[{name}] ...", file=sys.stderr, flush=True)
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if verbose:
            print(f"[{name}] {dt:.2f}s", file=sys.stderr, flush=True)

    def dump(self, path: Optional[str] = None) -> str:
        blob = json.dumps({"stages": self.stages, "counters": self.counters},
                          sort_keys=True)
        if path:
            with open(path, "w") as fh:
                fh.write(blob + "\n")
        return blob


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
