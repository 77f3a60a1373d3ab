"""Where the time of ``correct`` goes on the card.

    python -m rattle_tpu_torch.pipeline.profile_correct [--wall-only | --steps]

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED) through the CLI on cuda, then runs ``correct`` on
it twice: once plain, for the wall time, the peak device memory and the pack
engine's own section times (t_steps_s: the read steps), then once under
torch.profiler (CPU + CUDA activities) for the CUDA runtime's kernel launch
calls, the device busy time, poa_align's share of it and the rest (the
step's other kernels and operators; poa_thread's and poa_rerank's device
time apart), the idle share (1 - busy / wall of the
profiled run) and the top operators by device and by host time.  The last
line is one JSON object with these numbers.  ``--wall-only`` stops after the
plain run.  ``--steps`` times the read step's poa_thread and poa_rerank
instead of profiling the run: their device time a launch over every read
step of the run's largest group at each width (``replay_device_ms``), beside
each step's bound, and at step 12 of a synthetic group at each width
(``step_rows``), as lone calls and as launches queued back to back.  The
kernels are built first, outside the timed runs.

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

import numpy as np
import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.correct import pack_engine as pe
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline import cli
from rattle_tpu_torch.pipeline.profile_cluster import (_device_us,
                                                      launch_calls)
from rattle_tpu_torch.utils.synth import (_BASES, MAIN_FAMILIES,
                                          MAIN_READS, MAIN_SEED, mutate,
                                          synthetic_reads, write_fastq)

# read steps the timed synthetic groups are grown for, and the transcript
# lengths whose reads fill the three width configs
STEP_CAPTURE = 12
REF_LENS = (900, 1900, 3000)
# bytes each step kernel must move, a live node or position at a time:
# poa_thread reads a position's base and writes its path entry (5), gathers
# a matched node's perm, letter, leader, group size and members, letters,
# predecessors and group position (120), writes a new node's letter, leader,
# member slot and key (16), and reads an old node's leader and group
# position and writes its key (12); poa_rerank reads a live node's key,
# group size, leader, member slot, predecessors, count and letter (84) and
# writes its group position, rank, perm entry and rank-space row (88)
THREAD_POS_BYTES = 125
THREAD_NEW_BYTES = 16
THREAD_OLD_BYTES = 12
RERANK_NODE_BYTES = 172
# HBM3 bytes/s of an H100 SXM (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# device cycles of the sleep that queued_ms launches ahead of the timed
# launches (~10 ms at the H100's ~1.7 GHz), doubled while too short
SLEEP_CYCLES = 1 << 24


def _run(argv) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return time.perf_counter() - t0


def step_bytes(nn_old, nn_new, bases) -> tuple:
    """(poa_thread, poa_rerank) bytes of one read step: n_nodes of each lane
    before and after it and the read bases it threads (numpy arrays)."""
    thread = int((bases * THREAD_POS_BYTES + (nn_new - nn_old)
                  * THREAD_NEW_BYTES + nn_old * THREAD_OLD_BYTES).sum())
    return thread, int(nn_new.sum()) * RERANK_NODE_BYTES


def step_bases(st: dict, t: int, w: int) -> np.ndarray:
    """Read bases that step ``t`` threads in each lane (0 where the lane
    is idle or has fallen back), before the step."""
    active = (t < st["n_reads"]) & (st["fallback"] == 0)
    return (st["lens"][:, t].clamp(0, w) * active).cpu().numpy()


def lone_ms(fn, states) -> float:
    """Median CUDA-event time of ``fn(state)``, one call on each state (the
    wrapper's host path inside the timed window)."""
    fn(states[0])
    times = []
    for state in states[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, states) -> float:
    """Device time a launch of ``fn(state)``, one call on each state after
    a warm-up on the first: the calls are queued behind a sleep kernel, so
    the card runs them back to back and the host's wrapper time does not
    show.  Raises if the host took longer to queue them than the sleep
    lasted, after doubling it twice."""
    fn(states[0])
    cycles = SLEEP_CYCLES
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for state in states[1:]:
            fn(state)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / (len(states) - 1)
        cycles *= 2
    raise RuntimeError(f"queued_ms: queueing took {host_ms:.2f} ms, longer "
                       "than the sleep ahead of it")


def pack_group(dev, lanes, w: int, n_cap: int) -> dict:
    """The pack engine's initial state of a group whose lanes read
    ``lanes`` (lists of uint8 arrays) at width ``w``."""
    b, r_max = len(lanes), max(len(x) for x in lanes)
    seqs = np.zeros((b, r_max, w), np.uint8)
    lens = np.zeros((b, r_max), np.int32)
    for li, reads in enumerate(lanes):
        for t, x in enumerate(reads):
            seqs[li, t, :len(x)] = x
            lens[li, t] = len(x)
    n_reads = np.array([len(x) for x in lanes], np.int32)
    return pe._init_state(
        torch.from_numpy(seqs).to(dev), torch.from_numpy(lens).to(dev),
        torch.from_numpy(n_reads).to(dev), n_cap=n_cap,
        tot_cap=max(int(lens.sum(axis=1).max()), 1))


def grown_group(dev, w: int, n_cap: int, lanes: int, ref_len: int):
    """A group of ``lanes`` noisy packs of a transcript of ~``ref_len``
    bases each at width ``w``, grown for STEP_CAPTURE read steps: (the
    state, the next step t, poa_align's outputs of step t)."""
    rng = np.random.default_rng(w + 1)
    group = []
    for _ in range(lanes):
        ref = rng.choice(_BASES, int(ref_len * rng.uniform(0.9, 1.0)))
        group.append(sorted((mutate(rng, ref, 0.08)[:w - 2]
                             for _ in range(STEP_CAPTURE + 1)), key=len,
                            reverse=True))
    st = pack_group(dev, group, w, n_cap)
    scratch = torch.empty(kernels.poa_scratch_elems(lanes, n_cap, w),
                          dtype=torch.int16, device=dev)
    for t in range(STEP_CAPTURE):
        pe._step(st, t, w_eff=w, scratch=scratch)
    t = STEP_CAPTURE
    aligned = pe._align(st, t, w, scratch=scratch)
    torch.cuda.synchronize()
    return st, t, aligned


def step_rows(st: dict, t: int, w: int, aligned, copies: int = 8):
    """poa_thread and poa_rerank at read step ``t`` of ``st`` (left as it
    is), each timed as lone calls and queued back to back (``queued_ms``),
    poa_thread on ``copies`` copies of the state, poa_rerank on those
    copies after it (it rewrites what it reads, so it repeats on one
    state); poa_rerank's row has as ``sort_ms`` the one PyTorch call that
    computes a part of it, the stable sort of the keys
    (``torch.sort(keys[:, :N], stable=True)``, a lone call on the same
    states).  Returns (rows, a copy after both kernels)."""
    nn_old = st["n_nodes"].cpu().numpy()
    bases = step_bases(st, t, w)
    thread = lambda x: kernels.poa_thread(x, t, w, *aligned)  # noqa: E731
    states = [{k: v.clone() for k, v in st.items()} for _ in range(copies)]
    ms_t = lone_ms(thread, states)
    done = states[0]
    states = [{k: v.clone() for k, v in st.items()} for _ in range(copies)]
    dev_t = queued_ms(thread, states)
    nn_new = done["n_nodes"].cpu().numpy()
    ms_r = lone_ms(kernels.poa_rerank, states)
    dev_r = queued_ms(kernels.poa_rerank, states * 3)
    n = st["node_rank"].shape[1]
    lib_ms = lone_ms(lambda x: torch.sort(x["keys"][:, :n], dim=1,
                                          stable=True), states)
    del states
    rows = []
    for name, ms, dev_ms, sort_ms, nbytes in zip(
            ("poa_thread", "poa_rerank"), (ms_t, ms_r), (dev_t, dev_r),
            (None, lib_ms), step_bytes(nn_old, nn_new, bases)):
        bound = nbytes / PEAK_BYTES * 1e3
        rows.append(dict(kernel=name, step=t, width=w, lanes=len(nn_old),
                         nodes=[int(nn_old.sum()), int(nn_new.sum())],
                         max_nodes=int(nn_new.max()),
                         read_bases=int(bases.sum()), bytes=nbytes, ms=ms,
                         device_ms=dev_ms, bound_ms=bound,
                         share=bound / dev_ms, sort_ms=sort_ms))
    kernels.poa_rerank(done)
    return rows, done


class GroupCapture:
    """Hooks on correct/pack_engine.py's ``_init_state`` and ``_step`` for
    one ``correct`` run: at each width, the inputs of the group with the
    most lanes (the first on ties; references to the engine's uploads, no
    copy and no launch) and the arguments of each of its read steps."""

    def __init__(self):
        self._init, self._step = pe._init_state, pe._step
        self.groups = {}
        self._cur = None

    def init_state(self, seqs, lens, n_reads, n_cap, tot_cap):
        w, b = seqs.shape[2], seqs.shape[0]
        self._cur = None
        if b > self.groups.get(w, {}).get("lanes", 0):
            self._cur = self.groups[w] = dict(
                lanes=b, inputs=(seqs, lens, n_reads), n_cap=n_cap,
                tot_cap=tot_cap, steps=[])
        return self._init(seqs, lens, n_reads, n_cap=n_cap, tot_cap=tot_cap)

    def step(self, st, t, w_eff=None, **kw):
        if self._cur is not None:
            scores = {k: v for k, v in kw.items() if k != "scratch"}
            self._cur["steps"].append((t, w_eff, scores))
        return self._step(st, t, w_eff=w_eff, **kw)


@contextlib.contextmanager
def capturing_groups(cap: GroupCapture):
    pe._init_state, pe._step = cap.init_state, cap.step
    try:
        yield
    finally:
        pe._init_state, pe._step = cap._init, cap._step


def kernel_ms(prof, name: str) -> list:
    """Device milliseconds of each launch of the kernel whose name holds
    ``name`` in a profile, in launch order."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name), key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in ev]


def replay_device_ms(dev, cap: GroupCapture, check=None) -> dict:
    """Every read step of each captured group again under torch.profiler:
    poa_thread's and poa_rerank's device time summed over the steps beside
    the sum of each step's bound (``step_bytes`` from its lanes' nodes and
    read bases).  With ``check(st, t, w, scratch, scores)``, every step is
    first made by ``check``, outside the profile: it must advance ``st`` as
    the engine's ``_step`` does, and may run what it likes beside it, such
    as the plain versions.  The profiled pass runs the engine's steps and
    nothing else, so that no other launch crowds the trace (its device
    buffer drops records when it fills).  A trace that still lacks a
    step's launch is taken again, twice at most, and then raises.
    Returns {width: {lanes, steps, nodes, max_nodes, fallback_lanes,
    traces, poa_thread: {device_ms, bound_ms, share, steps_ms (each
    step's)}, poa_rerank: {...}}}."""
    rows = {}
    for w, g in sorted(cap.groups.items()):
        scratch = torch.empty(
            kernels.poa_scratch_elems(g["lanes"], g["n_cap"], w),
            dtype=torch.int16, device=dev)

        def init():
            return pe._init_state(*g["inputs"], n_cap=g["n_cap"],
                                  tot_cap=g["tot_cap"])

        if check is not None:
            st = init()
            for t, w_eff, scores in g["steps"]:
                check(st, t, w if w_eff is None else w_eff, scratch, scores)
            del st
        for traces in range(1, 4):
            st = init()
            nbytes = []
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for t, w_eff, scores in g["steps"]:
                    wt = w if w_eff is None else w_eff
                    nn_old = st["n_nodes"].cpu().numpy()
                    bases = step_bases(st, t, wt)
                    pe._step(st, t, w_eff=wt, scratch=scratch, **scores)
                    nbytes.append(step_bytes(
                        nn_old, st["n_nodes"].cpu().numpy(), bases))
                torch.cuda.synchronize()
            ms = {name: kernel_ms(prof, name + "_kernel")
                  for name in ("poa_thread", "poa_rerank")}
            short = [f"{len(v)} {k}" for k, v in ms.items()
                     if len(v) != len(nbytes)]
            if not short:
                break
            if traces == 3:
                raise RuntimeError(
                    f"replay W={w}: {len(nbytes)} steps but "
                    f"{' and '.join(short)} kernels in each of 3 traces")
        nn = st["n_nodes"]
        row = dict(lanes=g["lanes"], steps=len(g["steps"]),
                   nodes=int(nn.sum()), max_nodes=int(nn.max()),
                   fallback_lanes=int((st["fallback"] != 0).sum()),
                   traces=traces)
        for k, name in enumerate(("poa_thread", "poa_rerank")):
            bound = sum(b[k] for b in nbytes) / PEAK_BYTES * 1e3
            row[name] = dict(device_ms=sum(ms[name]), bound_ms=bound,
                             share=bound / sum(ms[name]), steps_ms=ms[name])
        rows[w] = row
        del st, scratch
    return rows


def _steps_report(dev, fq: str, clusters_out: str, out: str) -> dict:
    """``--steps``: the step kernels on the correct run's own groups and on
    the synthetic groups of chip_smoke.py's phase 4b."""
    cap = GroupCapture()
    with capturing_groups(cap):
        _run(["correct", "-i", fq, "-c", clusters_out, "-o", out])
    replay = replay_device_ms(dev, cap)
    del cap
    for w, r in replay.items():
        print(f"W={w}: {r['lanes']} lanes x {r['steps']} steps; " + "; ".join(
            f"{k} device {r[k]['device_ms']:.3f} ms, bound "
            f"{r[k]['bound_ms']:.3f} ms ({100 * r[k]['share']:.1f}%)"
            for k in ("poa_thread", "poa_rerank")))
    rows = {}
    for (w, n_cap, lanes), ref_len in zip(pe.CONFIGS, REF_LENS):
        st, t, aligned = grown_group(dev, w, n_cap, lanes, ref_len)
        rows[w], _done = step_rows(st, t, w, aligned)
        del st, aligned, _done
        torch.cuda.empty_cache()
        for r in rows[w]:
            print(f"{r['kernel']} W={w} lanes={lanes} step {t}: "
                  f"{r['nodes'][1]} nodes, lone {r['ms']:.4f} ms, device "
                  f"{r['device_ms']:.4f} ms a launch, bound "
                  f"{r['bound_ms']:.5f} ms ({100 * r['share']:.1f}%), "
                  f"torch.sort of the keys {r['sort_ms']} ms")
    return dict(replay={str(w): r for w, r in replay.items()},
                step_rows={str(w): r for w, r in rows.items()})


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
        if "--steps" in sys.argv[1:]:
            rep = _steps_report(torch.device("cuda"), fq,
                                os.path.join(tmp, "clusters.out"), tmp)
            print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                                  reads=MAIN_READS, **rep)))
            return 0
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
    step_s = {k: sum(_device_us(a) for a in avgs if k + "_kernel" in a.key)
              / 1e6 for k in ("poa_thread", "poa_rerank")}
    by_dev = sorted(avgs, key=_device_us, reverse=True)[:12]
    by_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                    reverse=True)[:12]
    print(f"{torch.cuda.get_device_name(0)}: {MAIN_READS} reads, correct "
          f"{wall:.3f} s unprofiled, {wall_prof:.3f} s profiled; device busy "
          f"{busy_s:.3f} s ({len(cuda_events)} device events), idle share "
          f"{1 - busy_s / wall_prof:.3f}; {sum(calls.values())} CUDA launch "
          f"calls {calls}; poa_align {poa_s:.3f} s, the rest "
          f"{busy_s - poa_s:.3f} s (poa_thread {step_s['poa_thread']:.4f} s, "
          f"poa_rerank {step_s['poa_rerank']:.4f} s); peak {peak_gib:.3f} GiB")
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
        "poa_thread_device_s": step_s["poa_thread"],
        "poa_rerank_device_s": step_s["poa_rerank"],
        "t_steps_s": stats.get("t_steps_s"), "peak_mem_gib": peak_gib,
        "engine": stats, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
