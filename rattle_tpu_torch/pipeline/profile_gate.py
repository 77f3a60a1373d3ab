"""Where the time of the decision wave's two kernels goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_gate [--out PATH]

Builds the main-path engine (utils/synth.py's MAIN_READS reads in the CLI's
order, ``cluster --rna`` parameters), runs its first block wave and first
sweep wave and keeps their gates' inputs and the sweep's win matrix, then
adds a 1,024 x every-read sweep (``wide_rows``) and the 4,096 x 65,536 tile
that every sweep wave gates above 65,536 reads (``BIG_TILE``: the first
4,096 reads against every read, repeated to 65,536 columns, the cache off
as it is above ``bulk.CACHE_MAX_N``).  For each gate it prints:

* ``lone_ms``: CUDA events around one call of ``kernels.gate_block`` (the
  wrapper's host path and its host read inside the window), median;
* ``device_ms``: the device time of a call, without the host read's copy:
  the durations of its kernels (and memsets) in torch.profiler's trace;
* ``split``: medians over calls, from the same traces: ``pass1`` (the
  device time of the activities up to pass 1's ``gate_tile_kernel``, the
  side kernel before it included), ``between`` (the device time of the
  activities after it and before the read's device-to-host copy),
  ``copy`` (that copy's), ``pass2`` (the activities after the copy),
  ``read_wait`` (host time inside the runtime's synchronising calls:
  the read's wait for the device) and ``host`` (the host clock of an
  unprofiled call, timed before the traces, less ``read_wait``);
* ``device_sequence``: one call's device activities in the order they ran,
  each with its device time, so what runs on the card between pass 1 and
  the read shows.

and for ``kernels.absorb_rest`` on the first sweep's win matrix, on a random
4,096 x 4,096 one (win density 0.0005) and on the big tile's ``w`` as its
gate leaves it (no cache, so no win: every column reads every row):
``lone_ms`` and ``device_ms``.  Where the checkout has them, the launch
plans (``kernels.gate_block_plan``, ``kernels.absorb_rest_plan``) are
printed beside each shape.  The last line is one JSON object of all this.

The imports are absolute, so the script also times another checkout:
``PYTHONPATH=<checkout> python <this file>`` run from that checkout.  The
gate's times come from the profiler's trace of a whole call, so they need
nothing of the checkout's wrapper beyond ``kernels.gate_block``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline.profile_cluster import SYNC_CALLS
from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                          MAIN_SEED, synthetic_reads)

# device cycles of the sleep that queued_ms launches ahead of the timed
# launches (~10 ms at the H100's ~1.7 GHz), doubled while too short
SLEEP_CYCLES = 1 << 24
# the sweep tile of every wave above SWEEP_TILE reads: k_block seed rows
# against SWEEP_TILE columns
BIG_TILE = (4096, bulk.SWEEP_TILE)
SPLIT_REPS = 9
QUEUED_CALLS = 12


def lone_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn`` (its host path inside
    the window)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = QUEUED_CALLS) -> float:
    """Device time of one call of ``fn``: ``calls`` calls queued behind a
    sleep kernel, so the card runs them back to back and the host's time
    does not show.  ``fn`` must not wait for the device.  Raises if the
    host took longer to queue them than the sleep lasted, after doubling
    it twice."""
    fn()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / calls
        cycles *= 2
    raise RuntimeError(f"queued_ms: queueing took {host_ms:.2f} ms, longer "
                       "than the sleep ahead of it")


# --------------------------------------------------------------------------
# the gate's split, from the profiler's trace of a call
# --------------------------------------------------------------------------


# traces taken of a call before one holds each pass and the read's copy:
# the profiler has been seen to drop pass 1's kernel from one trace in tens
# at the 4,096 x 65,536 tile
TRACE_TRIES = 4


def _trace(args, pass2: bool):
    """(device activities [(name, ms)] in the order they ran, host ms inside
    the runtime's synchronising calls) of one gate call under torch.profiler;
    the call first synchronises the card.  A trace without pass 1's kernel,
    the host read's copy or (where ``pass2``) pass 2's kernel is taken
    again, up to TRACE_TRIES times."""
    want = ["gate_tile_kernel", "Memcpy DtoH"] + ["gate_emit_kernel"] * pass2
    for _ in range(TRACE_TRIES):
        seq, wait = _trace_once(args)
        names = [n for n, _ms in seq]
        if all(any(w in n for n in names) for w in want):
            return seq, wait
    raise RuntimeError(f"profile_gate: {TRACE_TRIES} traces of a gate call "
                       f"lack one of {want}: {names}")


def _trace_once(args):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("gate call"):
            kernels.gate_block(*args)
        torch.cuda.synchronize()
    events = prof.events()
    call = next(e.time_range for e in events if e.name == "gate call")
    wait_us = sum(e.time_range.elapsed_us() for e in events
                  if e.name in SYNC_CALLS
                  and e.device_type != torch.autograd.DeviceType.CUDA
                  and call.start <= e.time_range.start
                  and e.time_range.end <= call.end)
    # the device's activities, less the call's own annotation span
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != "gate call"),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in dev], \
        wait_us / 1e3


def _stages(seq) -> dict:
    """A call's device activities summed by stage (ms): up to pass 1's tile
    kernel, after it up to the host read's copy, the copy, after it."""
    names = [n for n, _ms in seq]
    tile = max(i for i, n in enumerate(names) if "gate_tile_kernel" in n)
    copy = next((i for i, n in enumerate(names)
                 if i > tile and n.startswith("Memcpy DtoH")), len(names))
    ms = [m for _n, m in seq]
    return dict(pass1=sum(ms[:tile + 1]), between=sum(ms[tile + 1:copy]),
                copy=sum(ms[copy:copy + 1]), pass2=sum(ms[copy + 1:]))


def gate_split(args, pass2: bool, reps: int = SPLIT_REPS) -> dict:
    """Medians (ms) of one gate call on ``args`` as they are (w is folded in
    place, the same fold every call): its stages' device times and the
    device time a call (``device_ms``, the copy left out) from the
    profiler's traces, the read's wait there, and the host time of an
    unprofiled call (timed before any trace) less that wait.
    ``device_sequence``: the first trace's device activities.  ``pass2``:
    the call has fresh pairs, so pass 2 runs."""
    kernels.gate_block(*args)               # warms up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        kernels.gate_block(*args)
        walls.append((time.perf_counter() - h0) * 1e3)
    recs, seq0 = [], None
    for _ in range(reps):
        seq, wait = _trace(args, pass2)
        seq0 = seq0 or seq
        st = _stages(seq)
        recs.append(dict(st, device_ms=st["pass1"] + st["between"]
                         + st["pass2"], read_wait=wait))
    out = {k: statistics.median(r[k] for r in recs) for k in recs[0]}
    out["host"] = statistics.median(walls) - out["read_wait"]
    out["device_sequence"] = seq0
    return out


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------


def gate_args(eng, rows, cols, ordered: bool, words=None, groups=None,
              cache="mix", tab=None, w_density: float = 0.0,
              strand_val: int = 2, seed: int = 0):
    """gate_block's arguments for reads ``rows`` x ``cols`` of the engine's
    sketch: ``ordered`` tests row position < column position (a block),
    else every pair (a sweep); ``words`` the columns' packed words (default
    the forward sketch's); ``groups`` per read (default the engine's);
    ``cache`` "mix" (a random 0/1/2 score cache), None, or a tensor; ``tab``
    (default the main path's threshold); w with ``w_density`` of random
    1s and 2s."""
    dev = eng.device
    sk = eng.sk
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    c = torch.from_numpy(np.asarray(cols, np.int64)).to(dev)
    a, n_c = r.shape[0], c.shape[0]
    grp = eng._groups_dev if groups is None else groups
    if ordered:
        order_r = torch.arange(a, dtype=torch.int32, device=dev)
        order_c = torch.arange(n_c, dtype=torch.int32, device=dev)
    else:
        order_r = torch.zeros(a, dtype=torch.int32, device=dev)
        order_c = torch.ones(n_c, dtype=torch.int32, device=dev)
    if isinstance(cache, str):
        cache = torch.randint(0, 3, (eng.cache_n ** 2,), generator=g,
                              device=dev, dtype=torch.uint8)
    w = torch.zeros((a, n_c), dtype=torch.int8, device=dev)
    if w_density > 0:
        u = torch.rand((a, n_c), generator=g, device=dev)
        w = torch.where(u < w_density / 2, 1, torch.where(u < w_density, 2,
                                                          0)).to(torch.int8)
    return [sk.bvp[r], sk.bvc[r], order_r, grp[r],
            (sk.bvp if words is None else words)[c], sk.bvc[c], order_c,
            grp[c], eng._bv_table(eng.p.bv_threshold) if tab is None else tab,
            cache, eng.cache_n, r, c, w, strand_val, eng.nk, eng._bounds_dev]


def wide_rows(n: int) -> np.ndarray:
    """The 1,024 seed rows of the '1,024 x every read' sweep (seed 2, drawn
    after a 32-group --iso assignment of the n reads, as chip_smoke.py
    phase 2b draws them)."""
    rng = np.random.default_rng(2)
    rng.integers(0, 32, n)
    return rng.choice(n, min(1024, n), replace=False)


def big_tile_args(eng):
    """The 4,096 x 65,536 sweep tile: the first BIG_TILE[0] reads against
    every read repeated to BIG_TILE[1] columns, cache off, w zero."""
    a, c = BIG_TILE
    cols = np.resize(np.arange(eng.n), c)
    return gate_args(eng, np.arange(min(a, eng.n)), cols, False, cache=None)


class _Capture:
    """Pass-throughs for cluster/bulk.py's gate and sweep replay that keep
    every gate's inputs (w and the cache as they were before it) and every
    sweep replay's win matrix."""

    def __init__(self):
        self.gate, self.absorb = [], []

    def gate_block(self, *args):
        self.gate.append([a.clone() if i in (9, 13) and a is not None else a
                          for i, a in enumerate(args)])
        return kernels.gate_block(*args)

    def absorb_rest(self, w):
        self.absorb.append(w.clone())
        return kernels.absorb_rest(w)


def main_engine(dev):
    """The engine on the main-path reads, ``cluster --rna`` parameters."""
    reads = synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED)
    seqs = sorted((s for _n, s, _f in reads), key=len, reverse=True)
    return bulk.BulkClusterEngine(seqs, ClusterParams(is_rna=True),
                                  device=dev)


def capture_waves(eng):
    """The first block wave's and first sweep wave's gate inputs and the
    sweep's win matrix: ([block args, sweep args], [sweep w])."""
    cap = _Capture()
    saved = bulk.gate_block, bulk.absorb_rest
    bulk.gate_block, bulk.absorb_rest = cap.gate_block, cap.absorb_rest
    try:
        thr = eng.p.bv_threshold
        ids = np.arange(eng.k_block)
        packed = eng._wave(ids, ids, thr, ordered=True)
        seeds = ids[(packed >> 1) == ids]
        cols = np.arange(eng.k_block, min(eng.n, eng.k_block +
                                          eng.sweep_cpad))
        eng._wave(seeds, cols, thr, ordered=False)
    finally:
        bulk.gate_block, bulk.absorb_rest = saved
    return cap.gate[:2], cap.absorb[:1]


def _plan(name, *shape):
    fn = getattr(kernels, name, None)
    if fn is None:
        return None
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return fn(*shape, n_sm)


def gate_row(what: str, args) -> dict:
    """The lone call, the device time a call and the split of one gate."""
    a, c = args[0].shape[0], args[4].shape[0]
    run = list(args)
    run[13] = args[13].clone()
    rows, _cols, _cc, _n = kernels.gate_block(*run)
    sp = gate_split(run, rows.shape[0] > 0)
    row = dict(what=what, shape=[a, c], fresh=int(rows.shape[0]),
               lone_ms=lone_ms(lambda: kernels.gate_block(*run)),
               device_ms=sp.pop("device_ms"),
               device_sequence=sp.pop("device_sequence"), split=sp,
               plan=_plan("gate_block_plan", a, c))
    del rows
    print(f"  gate_block {what}: on the device, in order: "
          + ", ".join(f"{n[:40]} {ms:.4f}" for n, ms in row["device_sequence"]))
    print(f"  gate_block {what} [{a}x{c}], {row['fresh']} fresh: lone "
          f"{row['lone_ms']:.4f} ms, device a call {row['device_ms']:.4f} "
          f"ms (profiler); split: pass 1 {sp['pass1']:.4f}, between "
          f"{sp['between']:.4f}, copy {sp['copy']:.4f}, pass 2 "
          f"{sp['pass2']:.4f} (device), read wait {sp['read_wait']:.4f}, "
          f"host {sp['host']:.4f} ms (host clock); plan {row['plan']}",
          flush=True)
    return row


def absorb_row(what: str, w: torch.Tensor) -> dict:
    s, c = w.shape
    row = dict(what=what, shape=[s, c],
               lone_ms=lone_ms(lambda: kernels.absorb_rest(w)),
               device_ms=queued_ms(lambda: kernels.absorb_rest(w), 50),
               plan=_plan("absorb_rest_plan", s, c))
    print(f"  absorb_rest {what} [{s}x{c}]: lone {row['lone_ms']:.4f} ms, "
          f"device a launch {row['device_ms']:.4f} ms; plan {row['plan']}",
          flush=True)
    return row


def profile(dev) -> dict:
    eng = main_engine(dev)
    (block, sweep), (sweep_w,) = capture_waves(eng)
    big = big_tile_args(eng)
    gates = [("first wave's block", block), ("first sweep tile", sweep),
             ("sweep 1024 x every read", gate_args(
                 eng, wide_rows(eng.n), np.arange(eng.n), False, seed=4)),
             ("sweep tile 4096 x 65536", big)]
    rows = [gate_row(what, args) for what, args in gates]
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand((4096, 4096), generator=g, device=dev)
    rand_w = torch.where(u < 0.00025, 1, torch.where(u < 0.0005, 2, 0)).to(
        torch.int8)
    absorbs = [absorb_row(what, w) for what, w in (
        ("first sweep tile", sweep_w), ("random 4096x4096 p=0.0005", rand_w),
        ("sweep tile 4096 x 65536", big[13]))]
    return dict(gate_block=rows, absorb_rest=absorbs)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_gate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(f"device: {smi}; checkout {os.path.dirname(kernels.__file__)}")
    torch.cuda.synchronize()
    res = dict(device=smi, checkout=os.path.abspath(os.path.join(
        os.path.dirname(kernels.__file__), "..", "..")), **profile(dev))
    line = json.dumps(res)
    if "--out" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--out") + 1], "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
