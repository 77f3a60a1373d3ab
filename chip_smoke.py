"""Drive the PyTorch/CUDA port (rattle_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each ending in one summary line:
  1. device and build: the card's name and power limit; the eleven CUDA
     kernels and the tensor-core rate probe (csrc/mma_rate.cu) compiled with
     nvcc from rattle_tpu_torch/csrc (all at once), and the host aligner's
     library built from native/rattle_native.cpp into build/;
  2. bv_common against its plain version, exactly, at the main path's
     shapes and at ragged sizes off the 128 x 128 block tile, with
     CUDA-event times, the bf16 matmul yardstick and the share of the bound,
     whose 1-bit rate is the fastest timed in this run: the int8 peak
     scaled by the b1 / s8 ratio of register-only mma.sync loops, or a loop
     of wgmma .b1 from shared memory;
 2b. gate_block (the wave's gate: bv_common's product, on wgmma, with the
     tests, cache fold, class routing and compaction) and absorb_rest (the
     sweep replay) against their plain versions, exactly (rows, cols, class
     counts and w; the packed replay): on the main path's first block
     wave and first sweep wave (captured by the same _ScoreCapture as
     phase 3b, below), with a score cache of random 0/1/2, the cache off,
     --iso groups, the reverse strand, a table that passes nothing,
     threshold 0, ragged shapes and the 4,096 x 65,536 sweep tile of every
     wave above 65,536 reads; timed at the block, at two sweep tiles and at
     that tile (pipeline/profile_gate.py: the lone call, the device time of
     a call without the host read's copy from the profiler's trace, the
     split of a call into pass 1, the work between the passes, the read's
     copy and wait, pass 2 and the host, and the launch plan) beside the
     plain version and its bound (bit products at phase 2's 1-bit rate, or
     the bytes it counts), absorb_rest on the sweep's win matrix, a random
     4,096 x 4,096 one and that tile's (lone, device a launch, plan);
  3. lis_filter against its plain version (bases, hc and n_dist exactly,
     var to rtol 1e-5 with the same infinities): on synthetic lists at the
     three tiers' JAX chunk shapes and on the whole largest launch of each
     tier that the main path's first decision wave hands it, with that
     launch's own bound (the plain side in slices of the launch, each with
     the launch's bound, because its scans over a whole launch would not
     fit; timed as lone calls, with the share of the bound; the wave runs
     under torch.profiler, which splits lis_filter's launches and device
     time by tier and by (M, B, bound bucket)), on the adversarial lists of
     rattle_tpu_torch/utils/synth.lis_cases and at ragged B (1, 33, 4097);
 3b. the score path's kernels against their plain versions, every output
     exact: join_expand and score_decide on every launch of that same first
     wave at its own shape (a whole (class, tier) range unless its working
     set passes the engine's LAUNCH_BYTES), the plain side in slices of the
     launch because a whole range's gathers would not fit; join_expand on
     the adversarial tables of utils/synth.join_cases (one hash over whole
     rows, nk = 1, unequal widths, k = 16 hashes >= 2^31, a class-3 width
     of 6144, rows wider than shared memory, equal-hash runs longer than a
     thread's merge share), greedy_owner on the wave's block win matrix and
     on random ones at K = 4,096; lone calls timed at the largest launch of
     each (class width, M tier) and at the JAX engine's chunk of it, beside
     the plain versions and each kernel's bound, with the join kernel's
     launch shape and occupancy;
  4. poa_align against its plain version, exactly (best score, move count
     and the packed moves), on read steps captured from pack groups at
     W = 1024, 2048 and 4096, called as the engine calls it (the read and
     its length in place in the pack's tensors, activity from the step,
     n_reads and fallback), with an empty-graph lane, a lane past its last
     read, a fallen-back lane and a lane whose read is unrelated to its
     graph, with the time a rank
     and the DP / traceback split of the slowest lane (the kernel's
     nanosecond stamps); and on the adversarial graphs of
     rattle_tpu_torch/utils/synth.poa_cases at W = 1024 and 4096;
 4b. poa_thread and poa_rerank (the rest of the pack engine's read step)
     against their plain versions, every state field exact after every
     read step of a group at W = 1024, 2048 and 4096 whose lanes are noisy
     packs, a pack that goes idle, an empty lane, unrelated reads and one
     lane for each fallback cause (node, predecessor and group cap, each
     checked), with poa_rerank's count of lanes it had to sort
     (``sort_lanes``, 0: every lane ordered by counting); then poa_rerank
     on that group's last state with the keys of three lanes broken
     (a repeated old group position, a negative key, new groups' keys
     decreasing), every field exact and exactly those lanes sorted; then
     timed at the main path's lane counts (256 / 128 / 64 lanes) after 12
     read steps, as lone calls and as device time a launch (launches
     queued back to back behind a sleep kernel), beside their plain
     versions, their bounds and, for poa_rerank, torch.sort of the keys
     (phase 6 holds them on the main path's own groups too);
  5. the main path: ``cluster --rna`` on 8,192 synthetic reads through the
     port's CLI on cuda, then ``cluster_summary`` and ``extract_clusters``;
     then ``cluster`` in cDNA mode (both strands) and ``cluster --rna
     --iso`` on 8,192 reads; in each run every read must land in one
     cluster and every cluster kernel must have run, and lis_filter's
     launches are split by (tier M, launch B)
     (``kernels.lis_filter.shapes``), beside the run's peak device memory,
     its sections' host and device times and its host reads (at most two
     a strand and one a wave outside the rare paths, checked; bv_common
     never launches: its product runs inside gate_block); the ``--rna`` and
     cDNA runs again under torch.profiler for their CUDA launch calls,
     synchronising calls, device busy time and idle share; and each of the
     three again with the wave's five wrappers (gate, score path, both
     replays) pointed at their plain versions (a switch of this script),
     whose clusters.out must equal the kernel run's byte for byte;
  6. the correct path: ``correct`` on the ``--rna`` run's reads and
     clusters.out (reads of 300-3,000 bp, packs of up to 200 reads, all
     three widths; one launch of each of poa_align, poa_thread and
     poa_rerank a read step, its t_steps_s, poa_rerank's sort_lanes); the
     run's largest group at each width (its uploads and step arguments kept
     by hooks on the engine) is stepped again with poa_thread and
     poa_rerank against their plain versions, every state field exact
     after every step, under torch.profiler: each kernel's device time
     summed over the steps beside the sum of each step's bound; the run
     again under torch.profiler for its CUDA launch calls, then ``polish
     --rna --summary`` on its consensi.fq;
  6c. the lockstep runner: ``correct`` with RATTLE_POA_BACKEND=lockstep on
     a seed-fixed cut of phase 6's clusters (every l_cap class and the
     largest pack kept; graphs on the host, one poa_align_batch launch a
     read step), its three files byte for byte the pack engine's on the
     same cut, with its read steps, aligning and host seconds and packs on
     the card and on the host; poa_align_batch against its plain version,
     exactly (moves, length, aligned), on the run's largest read step at
     each of W = 1024, 2048 (int16 cells) and 4096 (int32) with an
     empty-graph lane, an unrelated read, a read past the end of its graph
     and an idle lane (pipeline/profile_lockstep.py's helpers), timed as
     lone calls beside the plain version and its bound (the larger of 32
     int32 operations a DP cell and the bytes of its inputs and moves);
     then ``correct`` on cuda with RATTLE_POA_BACKEND=lockstep and =native
     on phase 7's rna parity reads, held to ``--poa-backend host`` with
     phase 7's runs;
  7. parity on 256 reads of the same generator: ``cluster`` (rna, cDNA) and
     ``cluster --iso`` must write the same clusters.out as ``--oracle``, and
     so must ``cluster --rna`` with every borderline pair, then every pair
     over 128 matches, rescored on the host in f64;
     ``correct`` on cuda on the rna, cDNA and --iso clusters the same
     three files as ``--poa-backend host`` with no pack on the host
     aligner (the host runs are processes of their own, started as soon
     as their clusters exist and held to the device runs after phase 8);
     ``polish`` on cuda the same transcriptome.fq as ``polish --oracle
     --poa-backend host`` on the same consensi;
  8. the multi-process cluster path: two ranks of one gloo process group
     (this script's ``--rank-worker``, started by parallel.launch.run_ranks
     under the RATTLE_* contract, both on cuda:0, each under one deadline)
     run through the CLI: on phase 7's 256 reads ``cluster --rna`` and cDNA
     ``cluster``, each on the mesh and with ``--shard-input``, and
     ``cluster --iso`` on the mesh, every rank-0 clusters.out equal to
     ``--oracle``'s; ``cluster --rna --shard-input`` with every borderline
     pair rescored on the host, at least one rescore needing the other
     rank's read; at full size ``cluster --rna`` and cDNA ``cluster`` with
     ``--shard-input`` on phase 5's 8,192 reads, equal to phase 5's
     output, with every cluster kernel but bv_common launched on each
     rank; and
     ``polish --rna --summary`` on phase 6's consensi.fq, equal to phase
     6's files.  Rank 1 writes nothing.  The phase line gives each run's
     wall time beside phase 5's single-process time, each rank's bytes and
     seconds in collectives and its launch counts.

Launch counts are set to 0 just before each CLI run and read just after it
(in each rank for phase 8); the kernels line reports the cluster kernels
from the ``--rna`` ``cluster`` run (bv_common's launches there are 0: its
lone-call numbers are phase 2's), poa_align, poa_thread and
poa_rerank from the ``correct`` run and poa_align_batch from the lockstep
``correct`` run.  With ``--kernels-only`` the script
stops after phase 4b (a quick build-and-compare of the kernels) and prints
no final ``ok`` line.  Every process the script starts is stopped by its
end.

Any failed check ends the run with a non-zero exit.  The last two lines are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.  Scratch
files and the full report (report.json) go under build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8 ops/s on the
# tensor cores, and int32 ops/s outside them (half the 67 TFLOP/s float32
# rate: an SM has 64 int32 lanes to its 128 float32 lanes).  No 1-bit rate
# is published; phase 2 derives one (_b1_peak).
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_INT32 = 33.5e12
# integer operations poa_align spends on one DP cell (the F and diagonal
# candidates 7, A and the scan term 5, the prefix maximum and E 4, H 1, the
# direction word and its stores 12, the running best 3)
POA_OPS_PER_CELL = 32

N_PARITY = 256
# seconds phase 7's host correct runs may still take once phase 8 is done
HOST_CORRECT_S = 600


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
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


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    from rattle_tpu_torch import _ext
    t0 = time.perf_counter()
    report = _ext.build(_ext.KERNELS + _ext.PROBES)
    build_s = time.perf_counter() - t0
    for name in _ext.KERNELS:
        _ext.load(name)
    for name, (secs, log) in report.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  build {name}: {secs:.2f} s; {' | '.join(regs)}")
    # the host aligner's library, built from native/rattle_native.cpp
    from rattle_tpu_torch import native
    t0 = time.perf_counter()
    check(native.available(), "the native library did not build")
    native_s = time.perf_counter() - t0
    print(f"  build native: {native_s:.2f} s; loaded {native.SO}")
    print(f"phase 1 device+build: {smi[0]}; {len(_ext.KERNELS)} kernels "
          f"built in {build_s:.2f} s (compiled now: {sorted(report)}), the "
          f"native library in {native_s:.2f} s")
    return smi[0], build_s


def _random_words(p: int, density: float, dev, seed: int) -> torch.Tensor:
    from rattle_tpu_torch.ops.sketch_device import pack_bits
    g = torch.Generator(device=dev).manual_seed(seed)
    plane = torch.rand((p, 4096), generator=g, device=dev) < density
    return pack_bits(plane.to(torch.uint8))


BV_RAGGED = ((1000, 777), (1, 129), (15, 1), (129, 15), (1, 1))
MMA_CHAINS = 8          # accumulator chains a warp in csrc/mma_rate.cu
WGMMA_BATCH = 4         # wgmmas an iteration a warpgroup there


def _b1_peak(dev):
    """ops/s a bound on 1-bit MMAs assumes: the fastest 1-bit rate measured
    here, the larger of the published int8 peak times the ratio of the
    rates at which register-only loops of mma.sync .b1 (m16n8k256) and .s8
    (m16n8k32) run on every SM of this card (at least the int8 peak), and
    the rate of a loop of wgmma m64n128k256 .b1 from shared memory on every
    SM.  Returns (peak, {"b1": ops/s, "s8": ops/s, "wgmma_b1": ops/s})."""
    from rattle_tpu_torch import _ext
    from rattle_tpu_torch.ops.kernels import _raise_on, _stream
    fn = _ext.load("mma_rate").mma_rate_launch
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    rates = {}
    for kind, name, k, iters in ((0, "b1", 256, 64), (1, "s8", 32, 512),
                                 (2, "wgmma_b1", 256, 64)):
        ms = time_ms(lambda: _raise_on(fn(kind, iters, blocks, out.data_ptr(),
                                          _stream(dev)), "mma_rate"), reps=5)
        if kind < 2:        # 8 warps, each MMA_CHAINS m16n8 MMAs an iteration
            ops = blocks * 8 * iters * MMA_CHAINS * 2 * 16 * 8 * k
        else:               # 2 warpgroups, each WGMMA_BATCH m64n128 wgmmas
            ops = blocks * 2 * iters * WGMMA_BATCH * 2 * 64 * 128 * k
        rates[name] = ops / ms * 1e3
    return max(PEAK_INT8 * max(1.0, rates["b1"] / rates["s8"]),
               rates["wgmma_b1"]), rates


def phase_bv_common(dev):
    """The kernel exactly against the plain version at the main path's
    shapes and at sizes off the 128 x 128 block tile."""
    from rattle_tpu_torch.ops import kernels
    peak_b1, mma = _b1_peak(dev)
    print(f"  mma.sync from registers: b1 {mma['b1'] / 1e12:.1f}, s8 "
          f"{mma['s8'] / 1e12:.1f} TOP/s; wgmma b1 from shared memory "
          f"{mma['wgmma_b1'] / 1e12:.1f} TOP/s; the bound's 1-bit rate "
          f"{peak_b1 / 1e12:.1f} TOP/s (the larger of wgmma b1's and the "
          f"int8 peak {PEAK_INT8 / 1e12:.0f} x max(1, b1 / s8))")
    rows = []
    # a block wave, a sweep tile, then ragged shapes (zero rows in the first);
    # bit densities of 1,000-3,000 bp reads (~25-50% of the 4,096 6-mers)
    for p, s in ((4096, 4096), (1024, 8192), *BV_RAGGED):
        pool = _random_words(p, 0.35, dev, seed=p)
        seed = _random_words(s, 0.45, dev, seed=p + 1)
        if p == 1000:
            pool[-7:] = 0
        got = kernels.bv_common(pool, seed)
        ref = kernels.bv_common_plain(pool, seed)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        check(err == 0, f"bv_common [{p}x{s}] differs from plain by {err}")
        if p == 1000:
            check(bool((got[-7:] == 0).all()), "zero rows not inert")
        if (p, s) in BV_RAGGED:
            continue
        ms = time_ms(lambda: kernels.bv_common(pool, seed))
        plain_ms = time_ms(lambda: kernels.bv_common_plain(pool, seed), 5)
        a = kernels.unpack_bits(pool).to(torch.bfloat16)
        b = kernels.unpack_bits(seed).to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.matmul(a, b.T))
        nbytes = (p + s) * 512 + p * s * 4
        ops = 2 * p * s * 4096
        bound = max(nbytes / PEAK_BYTES, ops / peak_b1) * 1e3
        row = dict(shape=[p, s], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound,
                   bound_by="bytes" if nbytes / PEAK_BYTES > ops / peak_b1
                   else "operations", bound_share=bound / ms,
                   bound_ops_per_s=peak_b1, mma_sync_ops_per_s=mma,
                   max_abs_err=err)
        rows.append(row)
        print(f"  bv_common [{p}x128]x[{s}x128]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({row['bound_by']}), {100 * bound / ms:.1f}% "
              f"of the bound, {library_ms / ms:.2f}x the matmul's speed")
    print("phase 2 bv_common: exact against the plain version at "
          f"[4096x4096], [1024x8192] and ragged {[list(x) for x in BV_RAGGED]}")
    return rows


# the JAX engine's fixed chunk sizes (rattle_tpu/cluster/bulk.py
# COUNT_CHUNKS, SCORE_CHUNKS: pairs a chunk by class, and by class and M
# tier); phases 3 and 3b time the kernels at these shapes too, beside the
# port's launches, which take whole (class, tier) ranges
JAX_COUNT_CHUNKS = (4096, 2048, 1024, 512)
JAX_SCORE_CHUNKS = ((4096, 2048, 512), (2048, 1024, 256), (1024, 512, 128),
                    (512, 256, 64))


def _match_lists(b: int, m: int, dev, seed: int):
    """utils/synth.match_lists on the card, with the batch's largest count
    as the bound (the engine's own bound)."""
    from rattle_tpu_torch.utils.synth import match_lists
    p1, p2, valid, n_valid = match_lists(np.random.default_rng(seed), b, m)
    t = [torch.from_numpy(x).to(dev) for x in (p1, p2, valid)]
    bound = torch.tensor([int(n_valid.max())], dtype=torch.int32, device=dev)
    return t, bound


class _ScoreCapture:
    """Pass-throughs for cluster/bulk.py's wave kernels that keep, for every
    launch, the inputs of the join and of the decision that follows it (the
    win matrix and score cache as they were before it), by (class width,
    m_cap) in launch order, every block replay's win matrix, and every
    gate's and sweep replay's inputs (w and the cache as they were before
    the gate).  With ``score`` False only the gate's and the sweep replay's
    are kept.  The engine's own calls run unchanged."""

    def __init__(self):
        from rattle_tpu_torch.ops import kernels
        self.join, self.decide, self.greedy = {}, {}, []
        self.gate, self.absorb = [], []
        self.score = True
        self._key = None

        def join_expand(*args, total=None, bound=None):
            if self.score:
                self._key = (args[6].shape[1], args[11])
                kept = [a.clone() if i < 2 else a
                        for i, a in enumerate(args)]
                self.join.setdefault(self._key, []).append(kept)
            return kernels.join_expand(*args, total=total, bound=bound)

        def score_decide(*args, border=None):
            if self.score:
                self.decide.setdefault(self._key, []).append(
                    [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args])
            return kernels.score_decide(*args, border=border)

        self.join_expand, self.score_decide = join_expand, score_decide

    def greedy_owner(self, w, n_valid):
        from rattle_tpu_torch.ops import kernels
        if self.score:
            self.greedy.append((w.clone(), n_valid))
        return kernels.greedy_owner(w, n_valid)

    def gate_block(self, *args):
        from rattle_tpu_torch.ops import kernels
        self.gate.append([a.clone() if i in (9, 13) and a is not None else a
                          for i, a in enumerate(args)])
        return kernels.gate_block(*args)

    def absorb_rest(self, w):
        from rattle_tpu_torch.ops import kernels
        self.absorb.append(w.clone())
        return kernels.absorb_rest(w)


def _capture_lists(dev):
    """The largest launch of each tier that the main path's first decision
    wave hands lis_filter, with its bound: the engine on utils/synth's main-path reads in
    the CLI's order (stable length sort), ``cluster --rna`` parameters, one
    block wave, run under the profiler, whose split of lis_filter's launches
    and device time by tier and by (M, B, bound bucket) it prints.  The same
    wave's score-path inputs are kept by a _ScoreCapture, and so are the
    gate's and the replay's of the first sweep wave that follows it (the
    block's seeds against the first columns after it).  Returns ({M: [p1,
    p2, valid, bound]}, the capture, with the engine as ``cap.engine``)."""
    from rattle_tpu_torch.cluster import bulk
    from rattle_tpu_torch.config import ClusterParams
    from rattle_tpu_torch.pipeline.profile_cluster import (lis_split,
                                                           print_split)
    from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                              MAIN_SEED, synthetic_reads)
    reads = synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED)
    seqs = sorted((s for _n, s, _f in reads), key=len, reverse=True)
    params = ClusterParams(is_rna=True)
    eng = bulk.BulkClusterEngine(seqs, params, device=dev)
    ids = np.arange(eng.k_block)
    cap = _ScoreCapture()
    cap.widths = eng._cls_widths
    cap.engine = eng
    packed = []
    with _bulk_names(**{n: getattr(cap, n) for n in SCORE_PATH}):
        split, _prof, kept = lis_split(
            lambda: packed.append(eng._wave(ids, ids, params.bv_threshold,
                                            ordered=True)),
            keep=True)
        cap.score = False
        seeds = ids[(packed[0] >> 1) == ids]
        cols = np.arange(eng.k_block, min(eng.n, eng.k_block +
                                          eng.sweep_cpad))
        eng._wave(seeds, cols, params.bv_threshold, ordered=False)
    print_split("first wave (profiled)", split)
    return kept, cap


def _lis_slices(p1):
    """Slices of one launch's pairs for lis_filter_plain: as many pairs a
    slice as the engine's launch rule gives the plain versions' lists and
    [B, M] scan temporaries."""
    from rattle_tpu_torch.cluster.bulk import launch_pairs
    from rattle_tpu_torch.ops import kernels
    b, m = p1.shape
    step = launch_pairs(b, kernels.score_pair_bytes(kernels.join_expand_plain,
                                                    p1, 0, 0, m))
    return [slice(i, i + step) for i in range(0, b, step)]


def _lis_check(what: str, args, bound, slices=None):
    """The kernel against the plain version on one batch (the plain version
    over ``slices`` of it, each with the batch's bound, when given): bases,
    hc and n_dist exact, var with the same inf pattern and within rtol
    1e-5.  Returns (var's largest absolute difference over the finite
    values, ms of the plain run)."""
    from rattle_tpu_torch.ops import kernels
    got = kernels.lis_filter(*args, 10, 10, bound)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [kernels.lis_filter_plain(*(a[sl] for a in args), 10, 10, bound)
            for sl in (slices or [slice(None)])]
    ref = [torch.cat(x) for x in zip(*outs)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name, g_, r_ in zip(("bases", "hc", "n_dist"), got, ref):
        check(torch.equal(g_, r_), f"lis_filter {what}: {name} differs")
    finite = torch.isfinite(ref[3])
    check(torch.equal(torch.isfinite(got[3]), finite),
          f"lis_filter {what}: var inf pattern differs")
    check(torch.allclose(got[3][finite], ref[3][finite], rtol=1e-5,
                         atol=1e-5), f"lis_filter {what}: var off")
    if not bool(finite.any()):
        return 0.0, plain_ms
    return float((got[3][finite] - ref[3][finite]).abs().max()), plain_ms


def _lis_row(what: str, args, bound, sliced: bool = False) -> dict:
    """Check, time and bound one batch: the kernel and the plain version
    (lone calls, as the other kernels are timed: on lists this short the
    wrapper's host path is part of a call's time; ``sliced``: a whole
    launch, the plain version in ``_lis_slices`` of it, timed once, in the
    check), and the bytes the function must move on these lists: valid up
    to the bound (1 byte a slot), p2 at the valid slots and p1 at the LIS
    anchors (4 bytes each), the bound itself and four [B] outputs."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.ops.lis_select import lis_build_select
    p1, p2, valid = args
    b, m = p1.shape
    err, plain_ms = _lis_check(what, args, bound,
                               _lis_slices(p1) if sliced else None)
    ms = time_ms(lambda: kernels.lis_filter(p1, p2, valid, 10, 10, bound))
    if not sliced:
        plain_ms = time_ms(lambda: kernels.lis_filter_plain(
            p1, p2, valid, 10, 10, bound), reps=2 if m >= 2048 else 3,
            warmup=1)
    nb = int(bound)
    lis_len = lis_build_select(p2[:, :nb], valid[:, :nb])[2]
    nbytes = (b * nb + 4 * int(valid[:, :nb].sum())
              + 4 * int(lis_len.sum()) + 4 + 16 * b)
    row = dict(lists=what, shape=[b, m], bound=nb,
               valid=int(valid[:, :nb].sum()), lis=int(lis_len.sum()), ms=ms,
               plain_ms=plain_ms, library_ms=None,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               max_abs_err=err)
    print(f"  lis_filter {what} B={b} M={m} bound={nb}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {row['bound_ms']:.5f} ms (bytes), "
          f"{100 * row['bound_ms'] / ms:.2f}% of the bound; "
          f"{row['valid']} valid, LIS total {row['lis']}; var max abs err "
          f"{err:.3g}")
    return row


LIS_RAGGED = ((1, 128), (33, 512), (4097, 128))
LIS_ADVERSARIAL = ((256, 128), (64, 2048))


def phase_lis(dev, kept):
    """The kernel against its plain version on synthetic lists at the three
    tiers' chunk shapes, on the whole largest launch of each tier that the
    main path's first wave hands it with that launch's own bound (``kept``,
    from _capture_lists), on the adversarial lists of utils/synth.lis_cases
    and at ragged B."""
    from rattle_tpu_torch.utils.synth import lis_cases
    rows = []
    for tier, m in enumerate((128, 512, 2048)):
        b = JAX_SCORE_CHUNKS[0][tier]
        args, bound = _match_lists(b, m, dev, seed=m)
        rows.append(_lis_row("synthetic", args, bound))
    for p1, p2, valid, bound in kept.values():
        rows.append(_lis_row("main path launch", [p1, p2, valid], bound,
                             sliced=True))
    names = []
    for b, m in LIS_ADVERSARIAL:
        for name, *arrs, bnd in lis_cases(b, m):
            args = [torch.from_numpy(x).to(dev) for x in arrs]
            bound = torch.tensor([bnd], dtype=torch.int32, device=dev)
            _lis_check(f"{name} B={b} M={m}", args, bound)
            names.append(name)
    for b, m in LIS_RAGGED:
        args, bound = _match_lists(b, m, dev, seed=b)
        _lis_check(f"ragged B={b} M={m}", args, bound)
    print("phase 3 lis_filter: bases/hc/n_dist exact, var within rtol 1e-5, "
          "at M = 128, 512, 2048, on the main path's largest launch of "
          "each tier with its own bound, the plain side in slices "
          f"((B, M) {[r['shape'] for r in rows[3:]]}), on the adversarial "
          f"lists {sorted(set(names))} at (B, M) {list(LIS_ADVERSARIAL)} and "
          f"at ragged (B, M) {list(LIS_RAGGED)}")
    return rows


# phase 2b: ragged gates (rows x columns, random reads, unordered) and the
# sweep replay's random win matrices (seed rows x columns, win density)
GATE_RAGGED = ((1000, 777), (1, 129), (129, 15), (15, 1), (333, 4097))
ABSORB_RANDOM = ((4096, 4096, 0.0005), (1, 1, 0.5), (3, 1000, 0.3),
                 (700, 4097, 0.0), (4096, 129, 0.02), (4096, 65536, 0.00002))
# bytes of one row's or column's vectors the gate reads: bvc, order, group,
# nk int32 and the read id int64
GATE_VEC_BYTES = 24


def _gate_same(what: str, args):
    """gate_block and gate_block_plain on the same inputs, each on its own
    copy of w: rows, cols, class counts (device and host) and w exact.
    Returns the kernel's outputs."""
    from rattle_tpu_torch.ops import kernels
    ka, pa = list(args), list(args)
    ka[13], pa[13] = args[13].clone(), args[13].clone()
    got = kernels.gate_block(*ka)
    ref = kernels.gate_block_plain(*pa)
    torch.cuda.synchronize()
    for name, x, y in zip(("rows", "cols", "class_counts"), got, ref):
        check(x.shape == y.shape and bool(torch.equal(x, y)),
              f"phase 2b {what}: {name} differ from the plain version "
              f"({tuple(x.shape)} against {tuple(y.shape)})")
    check(got[3] == ref[3], f"phase 2b {what}: host class counts {got[3]} "
          f"against {ref[3]}")
    check(bool(torch.equal(ka[13], pa[13])), f"phase 2b {what}: w differs "
          "from the plain version's")
    return got


def _gate_row(what: str, args, got, peak_b1: float) -> dict:
    """One gate timed as the kernel (profile_gate.gate_row: the lone call,
    the device time of a call without the host read's copy, the split of a
    call and the launch plan) and as the plain version (CUDA-event medians),
    beside
    its bound: the larger of its bit products at the 1-bit rate and its
    bytes (the packed words, each row's and column's vectors, the cache
    bytes of the passing pairs, the cached wins read and written in w, the
    fresh-pair mask and the pair list)."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.pipeline.profile_gate import gate_row
    a, c = args[0].shape[0], args[4].shape[0]
    row = gate_row(what, args)
    run = list(args)
    run[13] = args[13].clone()
    plain_ms = time_ms(lambda: kernels.gate_block_plain(*run), reps=3,
                       warmup=1)
    nocache = list(run)
    nocache[9] = None
    rows, cols, _cc, _n = kernels.gate_block(*nocache)
    wins = 0
    if args[9] is not None:
        cv = args[9][args[11][rows] * args[10] + args[12][cols]]
        wins = int((cv == 2).sum())
    fresh = got[0].shape[0]
    parts = dict(words=(a + c) * 512, vectors=(a + c) * GATE_VEC_BYTES
                 + 4097 * 4,
                 cache=rows.shape[0] if args[9] is not None else 0,
                 w=2 * wins, mask=a * -(-c // 32) * 4, pairs=fresh * 16)
    passing = int(rows.shape[0])
    del rows, cols, nocache
    nbytes = sum(parts.values())
    ops = 2 * a * c * 4096
    bound = max(nbytes / PEAK_BYTES, ops / peak_b1) * 1e3
    ms = row.pop("lone_ms")
    row.update(passing=passing, cached_wins=wins, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound,
               bound_by="bytes" if nbytes / PEAK_BYTES > ops / peak_b1
               else "operations", bound_share=bound / ms,
               device_bound_share=bound / row["device_ms"], bytes=parts,
               operations=ops, max_abs_err=0)
    print(f"    {passing} passing; plain {plain_ms:.4f} ms, bound "
          f"{bound:.5f} ms ({row['bound_by']}: {ops} bit operations, "
          f"{nbytes} bytes {parts}), {100 * bound / ms:.1f}% of the bound "
          f"(lone), {100 * bound / row['device_ms']:.1f}% (device a "
          "call); no PyTorch call computes the gate")
    return row


def _absorb_row(what: str, w: torch.Tensor) -> dict:
    """absorb_rest timed (profile_gate.absorb_row: the lone call, the
    device time a launch and the plan) beside its plain version and its
    bound: the bytes of the rows each column needs read up to its first win
    (every row where none wins) and the [C] int32 output."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.pipeline.profile_gate import absorb_row
    s_, c = w.shape
    row = absorb_row(what, w)
    plain_ms = time_ms(lambda: kernels.absorb_rest_plain(w))
    has = w > 0
    first = torch.argmax(has.to(torch.uint8), dim=0)
    read = torch.where(has.any(dim=0), first + 1, s_)
    nbytes = int(read.sum()) + 4 * c
    bound = nbytes / PEAK_BYTES * 1e3
    ms = row.pop("lone_ms")
    row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
               bound_by="bytes", bound_share=bound / ms,
               device_bound_share=bound / row["device_ms"], bytes=nbytes,
               max_abs_err=0)
    print(f"    plain {plain_ms:.4f} ms, bound {bound:.5f} ms (bytes: "
          f"{nbytes}), {100 * bound / ms:.1f}% of the bound (lone), "
          f"{100 * bound / row['device_ms']:.1f}% (device a launch)")
    return row


def phase_gate(dev, cap, peak_b1: float):
    """Phase 2b: gate_block exactly against gate_block_plain (rows, cols,
    class counts and w) on the first block wave's and the first sweep
    wave's own inputs (``cap``, from _capture_lists), and on the engine's
    reads with a score cache of random 0/1/2, the cache off, --iso-style
    groups, the reverse strand (strand_val 1, reverse-strand words, w
    already holding wins), a table that passes nothing, threshold 0 (an
    all-zero table), ragged shapes and the 4,096 x 65,536 sweep tile of
    every wave above 65,536 reads (profile_gate.big_tile_args); timed at the
    block, at the captured sweep tile, at a 1,024 x all-reads sweep and at
    the 4,096 x 65,536 tile (the lone call, the device time a launch, the
    split of a call, the plan).  absorb_rest exactly against
    absorb_rest_plain on the sweep's win matrix, on that tile's w (no win)
    and on random ones, timed at the sweep's, at a random 4,096 x 4,096 and
    at the 4,096 x 65,536 tile's."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.ops.sketch_device import build_device_sketch
    from rattle_tpu_torch.pipeline.profile_gate import (big_tile_args,
                                                        gate_args)
    eng = cap.engine
    check(len(cap.gate) == 2 and len(cap.absorb) == 1,
          f"phase 2b: captured {len(cap.gate)} gates and {len(cap.absorb)} "
          "sweep replays, expected a block's, then a sweep's")
    block, sweep = cap.gate
    blk = block[11].cpu().numpy()
    rng = np.random.default_rng(2)
    n = eng.n
    rev_bvp = build_device_sketch(eng.seqs, eng.p.kmer_size, True,
                                  device=dev).rev_bvp
    iso = torch.from_numpy(rng.integers(0, 32, n).astype(np.int32)).to(dev)
    wide = rng.choice(n, min(1024, n), replace=False)
    half = len(blk) // 2
    cases = [
        ("first wave's block", block),
        ("first sweep tile", sweep),
        ("block, cache 0/1/2, w 1% wins", gate_args(eng, blk, blk, True,
                                                     w_density=0.01)),
        ("block, cache off", gate_args(eng, blk, blk, True, cache=None)),
        ("block, --iso groups", gate_args(eng, blk, blk, True, groups=iso,
                                           seed=1)),
        ("block, reverse strand", gate_args(
            eng, blk, blk, True, words=rev_bvp, w_density=0.02,
            strand_val=1, seed=2)),
        ("block, nothing passes", gate_args(
            eng, blk, blk, True, tab=torch.full((4097,), 4097,
                                                dtype=torch.int32,
                                                device=dev))),
        ("threshold 0", gate_args(
            eng, blk[:min(1000, half)], blk[half:half + 777], True,
            tab=torch.zeros(4097, dtype=torch.int32, device=dev), seed=3)),
        ("sweep 1024 x every read", gate_args(eng, wide, np.arange(n),
                                               False, seed=4)),
        ("sweep, reverse strand, cache off", gate_args(
            eng, wide, np.arange(n), False, words=rev_bvp, cache=None,
            w_density=0.01, strand_val=1, seed=5)),
        ("sweep tile 4096 x 65536", big_tile_args(eng)),
    ]
    for i, (a, c) in enumerate(GATE_RAGGED):
        cases.append((f"ragged {a}x{c}", gate_args(
            eng, rng.choice(n, a, replace=False),
            rng.choice(n, c, replace=False), i % 2 == 0, w_density=0.01,
            seed=10 + i)))
    rows, outs = [], {}
    for what, args in cases:
        outs[what] = got = _gate_same(what, args)
        if what == "block, nothing passes":
            check(got[0].shape[0] == 0, "phase 2b: a pair passed the table "
                  "that passes nothing")
    check(outs["first wave's block"][0].shape[0] > 0
          and outs["threshold 0"][0].shape[0] > 0,
          "phase 2b: no fresh pair in the block or at threshold 0")
    for what in ("first wave's block", "first sweep tile",
                 "sweep 1024 x every read", "sweep tile 4096 x 65536"):
        rows.append(_gate_row(what, dict(cases)[what], outs[what], peak_b1))
        # the one host read follows pass 1 with nothing between them
        seq = [name for name, _ms in rows[-1]["device_sequence"]]
        tile = [i for i, n in enumerate(seq) if "gate_tile_kernel" in n]
        check(len(tile) == 1 and tile[0] + 1 < len(seq)
              and seq[tile[0] + 1].startswith("Memcpy DtoH"),
              f"phase 2b {what}: the device ran {seq}; the host read must "
              "follow pass 1 directly")
    del outs
    g = torch.Generator(device=dev).manual_seed(7)
    absorb_cases = [("first sweep tile", cap.absorb[0]),
                    ("sweep tile 4096 x 65536",
                     dict(cases)["sweep tile 4096 x 65536"][13])]
    for s_, c, dens in ABSORB_RANDOM:
        u = torch.rand((s_, c), generator=g, device=dev)
        absorb_cases.append((f"random {s_}x{c} p={dens}", torch.where(
            u < dens / 2, 1, torch.where(u < dens, 2, 0)).to(torch.int8)))
    absorb = []
    for what, w in absorb_cases:
        got = kernels.absorb_rest(w)
        ref = kernels.absorb_rest_plain(w)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, ref)), f"phase 2b absorb_rest {what}: "
              "differs from the plain version")
        if what in ("first sweep tile", "random 4096x4096 p=0.0005",
                    "sweep tile 4096 x 65536"):
            absorb.append(_absorb_row(what, w))
    # every case again, after all the timed launches
    for what, w in absorb_cases:
        check(bool(torch.equal(kernels.absorb_rest(w),
                               kernels.absorb_rest_plain(w))),
              f"phase 2b absorb_rest {what}: differs when run again")
    print(f"phase 2b gate_block + absorb_rest: gate_block exact (rows, cols, "
          f"class counts, w) against its plain version on {len(cases)} "
          f"cases ({', '.join(w for w, _a in cases)}), absorb_rest on "
          f"{len(absorb_cases)} win matrices")
    return dict(gate_block=rows, absorb_rest=absorb)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _distinct_row_entries(tab, n):
    """(entries, rows): the entries of the distinct table rows ``tab``
    names, row i holding n[i] of them (the same row always holds the same
    read, so the same n)."""
    uniq, inv = torch.unique(tab, return_inverse=True)
    per = torch.zeros(uniq.shape[0], dtype=torch.float64, device=tab.device)
    per.scatter_(0, inv, n.double())
    return float(per.sum()), uniq.shape[0]


def _join_bound(args, m_cap: int, total):
    """(bound ms, "bytes" or "operations", per-pair rows ms) of one
    join_expand call on these tables.  The bound: the bytes the function
    must move, each input read once (the pair indices, 16 bytes a pair; the
    hashes of each distinct table row the pairs name, 8 bytes an entry up to
    its read's nk, one row read once for both sides when the two tables are
    one, with its id, table index and nk; the positions of the kept
    matches, 4 bytes a side, or of those rows if fewer) and the outputs
    written once (9 bytes a list slot and total), against the operations of
    a merge of each pair's two rows (na + nb comparisons) and of the sort of
    its kept matches.  Per-pair rows: the bytes of both rows' hashes and
    positions for every pair (12 bytes an entry) with the same indices and
    outputs, what a kernel that stages each pair's rows on its own moves;
    it is not a bound for a launch whose pairs share rows through the
    cache."""
    rows, cols, row_ids, col_ids, row_tab, col_tab = args[:6]
    hs_a, hs_b, nk = args[6], args[8], args[10]
    wa, wb = hs_a.shape[1], hs_b.shape[1]
    na = nk[row_ids[rows]].clamp(max=wa)
    nb = nk[col_ids[cols]].clamp(max=wb)
    b = rows.shape[0]
    a_tab, b_tab = row_tab[rows], col_tab[cols]
    if hs_a.data_ptr() == hs_b.data_ptr() and hs_a.stride() == hs_b.stride():
        sides = [(torch.cat([a_tab, b_tab]), torch.cat([na, nb]))]
    else:
        sides = [(a_tab, na), (b_tab, nb)]
    entries = n_rows = 0
    for tab, n in sides:
        e, r = _distinct_row_entries(tab, n)
        entries, n_rows = entries + e, n_rows + r
    kept = float(torch.clamp(total, max=m_cap).sum())
    out_bytes = b * (9 * m_cap + 4) + 4
    nbytes = (16 * b + 8 * entries + 20 * n_rows + min(8 * kept, 4 * entries)
              + out_bytes)
    ops = float((na + nb).double().sum())
    lg = np.log2(max(2, _pow2(m_cap)))
    ops += b * _pow2(m_cap) / 2 * lg * (lg + 1) / 2
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_INT32
    pair_rows = float(12 * (na + nb).double().sum()) + b * 56 + out_bytes
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            pair_rows / PEAK_BYTES * 1e3)


def _plain_slices(args, m_cap: int):
    """Slices of one launch's pairs for the plain versions: as many pairs a
    slice as the engine's launch rule gives their working set (the [B, W]
    gathers of a whole launch would not fit)."""
    from rattle_tpu_torch.cluster.bulk import launch_pairs
    from rattle_tpu_torch.ops import kernels
    rows = args[0]
    n = rows.shape[0]
    step = launch_pairs(n, kernels.score_pair_bytes(
        kernels.join_expand_plain, rows, args[6].shape[1], args[8].shape[1],
        m_cap))
    return [slice(i, i + step) for i in range(0, n, step)]


def _join_plain_sliced(args, m_cap: int):
    """join_expand_plain over ``_plain_slices`` of the launch: (p1, p2,
    total, valid, bound) as one call would give them."""
    from rattle_tpu_torch.ops import kernels
    outs = [kernels.join_expand_plain(args[0][sl], args[1][sl], *args[2:],
                                      m_cap)
            for sl in _plain_slices(args, m_cap)]
    cat = [torch.cat(x) for x in zip(*(o[:4] for o in outs))]
    return (*cat, torch.stack([o[4] for o in outs]).max(dim=0).values)


def _join_check(what: str, args, m_cap: int):
    """The kernel against the plain version (in slices) on one launch: p1,
    p2, total, valid and bound all exact (overflow rows included: both keep
    the first m_cap matches in b order).  Returns the kernel's outputs."""
    from rattle_tpu_torch.ops import kernels
    got = kernels.join_expand(*args, m_cap)
    ref = _join_plain_sliced(args, m_cap)
    torch.cuda.synchronize()
    for name, g_, r_ in zip(("p1", "p2", "total", "valid", "bound"), got,
                            ref):
        check(torch.equal(g_, r_), f"join_expand {what}: {name} differs")
    return got


# score_decide's arguments that hold one entry a pair
DECIDE_PER_PAIR = (0, 1, 4, 5, 6)


def _decide_sliced(args, sl):
    return [a[sl] if i in DECIDE_PER_PAIR else a for i, a in enumerate(args)]


def _decide_plain_sliced(args, slices):
    from rattle_tpu_torch.ops import kernels
    return torch.cat([kernels.score_decide_plain(*_decide_sliced(args, sl))
                      for sl in slices])


def _decide_check(what: str, args, slices):
    """score_decide against its plain version (in ``slices`` of the launch,
    one after the other) from the same state: border, the win matrix and
    the score cache exact.  Returns (border, wins, decided)."""
    from rattle_tpu_torch.ops import kernels
    state = [[a.clone() if isinstance(a, torch.Tensor) else a for a in args]
             for _ in range(2)]
    got = kernels.score_decide(*state[0])
    ref = _decide_plain_sliced(state[1], slices)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"score_decide {what}: border differs")
    check(torch.equal(state[0][12], state[1][12]),
          f"score_decide {what}: w differs")
    cache = state[0][13]
    if cache is not None:
        check(torch.equal(cache, state[1][13]),
              f"score_decide {what}: score cache differs")
    wins = int((state[0][12] != args[12]).sum())
    decided = int((cache != args[13]).sum()) if cache is not None else 0
    return got, wins, decided


def _greedy_seed_bytes(w: np.ndarray, n_valid: int) -> int:
    """Bytes of ``w`` the replay must read: for each seed row, its columns
    after it below n_valid that are still unclaimed (a host replay)."""
    k = w.shape[0]
    owner = np.arange(k)
    need = 0
    for i in range(n_valid):
        if owner[i] != i:
            continue
        free = np.nonzero(owner[i + 1:n_valid] == np.arange(i + 1, n_valid))
        cols = free[0] + i + 1
        need += len(cols)
        owner[cols[w[i, cols] > 0]] = i
    return need


def _greedy_row(what: str, w: torch.Tensor, n_valid: int) -> dict:
    from rattle_tpu_torch.ops import kernels
    got = kernels.greedy_owner(w, n_valid)
    ref = kernels.greedy_owner_plain(w, n_valid)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"greedy_owner {what}: owners differ")
    ms = time_ms(lambda: kernels.greedy_owner(w, n_valid))
    plain_ms = time_ms(lambda: kernels.greedy_owner_plain(w, n_valid), reps=3,
                       warmup=1)
    owner = (got >> 1).cpu().numpy()
    seeds = int((owner[:n_valid] == np.arange(n_valid)).sum())
    need = _greedy_seed_bytes(w.cpu().numpy(), n_valid)
    nbytes = need + 4 * w.shape[0]
    t_b, t_o = nbytes / PEAK_BYTES, need / PEAK_INT32
    row = dict(matrix=what, shape=[w.shape[0], w.shape[0]], n_valid=n_valid,
               seeds=seeds, absorbed=int(n_valid - seeds), ms=ms,
               plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations",
               max_abs_err=0)
    print(f"  greedy_owner {what} K={w.shape[0]} n_valid={n_valid}: {seeds} "
          f"seeds; kernel {ms:.4f} ms ({ms * 1e3 / max(seeds, 1):.3f} us a "
          f"seed), plain {plain_ms:.2f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), exact")
    return row


# random block win matrices: (K, n_valid, win density)
GREEDY_RANDOM = ((4096, 4096, 0.002), (4096, 3000, 0.0005))


def _jax_chunk(cap, wa: int, m_cap: int) -> int:
    """The JAX engine's chunk of pairs for this class width and M tier."""
    cls_i = cap.widths.index(wa)
    tier = (128, 512, 2048).index(m_cap)
    return JAX_SCORE_CHUNKS[cls_i][tier] if tier else JAX_COUNT_CHUNKS[cls_i]


def _join_row(what: str, args, m_cap: int, plain_ms: float) -> dict:
    """Time one join_expand call (lone calls, CUDA-event median) beside
    its bound and the given plain time."""
    from rattle_tpu_torch.ops import kernels
    b = args[0].shape[0]
    ms = time_ms(lambda: kernels.join_expand(*args, m_cap))
    total = kernels.join_expand(*args, m_cap)[2]
    bound_ms, by, pair_rows_ms = _join_bound(args, m_cap, total)
    row = dict(chunk=what, shape=[b, args[6].shape[1], args[8].shape[1],
                                  m_cap],
               matches=int(torch.clamp(total, max=m_cap).sum()),
               overflow_pairs=int((total > m_cap).sum()), ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
               bound_by=by, pair_rows_ms=pair_rows_ms, max_abs_err=0)
    print(f"  join_expand {what} B={b}: {row['matches']} matches kept, "
          f"{row['overflow_pairs']} pairs over M; kernel {ms:.4f} ms, plain "
          f"(gathers + eager join) {plain_ms:.4f} ms, bound {bound_ms:.5f} "
          f"ms ({by}), {100 * bound_ms / ms:.2f}% of the bound; per-pair "
          f"rows {pair_rows_ms:.5f} ms ({100 * pair_rows_ms / ms:.2f}%)")
    return row


def _decide_row(what: str, args, plain_ms: float, wins: int,
                decided: int, border: int) -> dict:
    from rattle_tpu_torch.ops import kernels
    b = args[0].shape[0]
    live = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    ms = time_ms(lambda: kernels.score_decide(*live))
    nbytes = b * 57 + 2 * wins + decided + 8
    row = dict(chunk=what, shape=[b], wins=wins, decided=decided,
               border=border, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               max_abs_err=0)
    print(f"  score_decide {what} B={b}: {wins} wins, {decided} decided, "
          f"{border} border; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {row['bound_ms']:.5f} ms (bytes), "
          f"{100 * row['bound_ms'] / ms:.3f}% of the bound")
    return row


def phase_score_path(dev, cap):
    """join_expand and score_decide against their plain versions (eager
    PyTorch chains) on every launch of the main path's first wave, at the
    launch's own shape: the plain side runs in slices of the launch
    (``_plain_slices``: a whole range's [B, W] gathers would not fit), and
    the decision's slices one after the other on the same state.  The
    largest launch of each (class width, M tier) is timed as a lone call at
    its shape and at the JAX engine's chunk of the same class and tier (its
    first pairs), each beside its bound; the join kernel's launch shape
    (threads a pair, pairs a CTA, shared memory, CTAs an SM) is printed for
    each.  join_expand is also held on the adversarial tables of
    utils/synth.join_cases, and greedy_owner on the wave's block win
    matrix and on random ones at K = 4,096: every output exact."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.utils.synth import join_cases
    joins, decides, n_launches = [], [], 0
    shapes = {f"W={w} M={m}": kernels.join_expand_config(w, w, m)
              for w in cap.widths for m in (128, 512, 2048)}
    print("  join_expand launch shapes at the engine's class widths: "
          + "; ".join(f"{k}: {c['threads_a_pair']} threads a pair, "
                      f"{c['pairs_a_cta']} a CTA, {c['smem_bytes']} B, "
                      f"{c['ctas_an_sm']} CTAs an SM"
                      for k, c in shapes.items()))
    for (wa, m_cap), launches in sorted(cap.join.items()):
        what = f"W={wa} M={m_cap}"
        cfg = kernels.join_expand_config(wa, launches[0][8].shape[1], m_cap)
        print(f"  join_expand {what}: {len(launches)} launch(es) of "
              f"{[a[0].shape[0] for a in launches]} pairs; launch shape "
              f"{cfg}")
        big = max(range(len(launches)), key=lambda i: launches[i][0].shape[0])
        dlist = cap.decide.get((wa, m_cap), [])
        check(len(dlist) == len(launches),
              f"phase 3b {what}: {len(launches)} joins, {len(dlist)} "
              "decisions")
        for li, (args, dargs) in enumerate(zip(launches, dlist)):
            args = args[:11]
            n_launches += 1
            _join_check(f"{what} launch {li}", args, m_cap)
            slices = _plain_slices(args, m_cap)
            border, wins, decided = _decide_check(f"{what} launch {li}",
                                                  dargs, slices)
            if li != big:
                continue
            b = args[0].shape[0]
            plain_ms = time_ms(lambda: _join_plain_sliced(args, m_cap),
                               reps=1, warmup=0)
            joins.append(_join_row(f"main path {what} launch", args, m_cap,
                                   plain_ms))
            joins[-1]["plain_slices"] = len(slices)
            plain_ms = time_ms(lambda: _decide_plain_sliced(
                [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in dargs], slices), reps=1, warmup=0)
            decides.append(_decide_row(f"main path {what} launch", dargs,
                                       plain_ms, wins, decided,
                                       int(border.sum())))
            bc = _jax_chunk(cap, wa, m_cap)
            if bc >= b:
                continue
            sub = [args[0][:bc], args[1][:bc], *args[2:]]
            plain_ms = time_ms(lambda: kernels.join_expand_plain(*sub,
                                                                 m_cap),
                               reps=5)
            joins.append(_join_row(f"main path {what} JAX chunk", sub,
                                   m_cap, plain_ms))
            dsub = _decide_sliced(dargs, slice(0, bc))
            _b, wins, decided = _decide_check(f"{what} JAX chunk", dsub,
                                              [slice(0, bc)])
            plain_ms = time_ms(lambda: kernels.score_decide_plain(*[
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in dsub]))
            decides.append(_decide_row(f"main path {what} JAX chunk", dsub,
                                       plain_ms, wins, decided,
                                       int(_b.sum())))
    check(joins and decides, "phase 3b: the first wave captured no launch")
    names = []
    for name, arrs, m_cap in join_cases():
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        total = _join_check(f"adversarial {name}", args, m_cap)[2]
        names.append(f"{name} (W={args[6].shape[1]}/{args[8].shape[1]}, "
                     f"M={m_cap}, totals {int(total.min())}-"
                     f"{int(total.max())})")
    print(f"  join_expand adversarial tables exact: {'; '.join(names)}")
    greedy = [_greedy_row(f"main path block {i}", w, n)
              for i, (w, n) in enumerate(cap.greedy)]
    check(greedy, "phase 3b: the first wave made no block replay")
    g = torch.Generator(device=dev).manual_seed(4096)
    for k, n_valid, dens in GREEDY_RANDOM:
        r = torch.rand((k, k), generator=g, device=dev)
        w = torch.where(r < dens / 2, 1, torch.where(r < dens, 2, 0)).to(
            torch.int8)
        greedy.append(_greedy_row(f"random p={dens}", w, n_valid))
    print("phase 3b score path: join_expand and score_decide exact against "
          f"their plain versions on all {n_launches} launches of the first "
          f"wave, join_expand on {len(names)} adversarial tables, "
          f"greedy_owner on {len(cap.greedy)} main-path block(s) and "
          f"{len(GREEDY_RANDOM)} random K=4096 matrices")
    return dict(join_expand=joins, score_decide=decides, greedy_owner=greedy,
                join_shapes=shapes)


POA_CAPTURE_STEP = 12
POA_LANES = 4
WIDTHS = [1024, 2048, 4096]


def _capture_step(dev, w: int, n_cap: int, ref_len: int, seed: int):
    """Grow POA_LANES pack graphs for POA_CAPTURE_STEP read steps on the
    card through the engine's own ``_step`` (kernel included) and return the
    group's rank-space inputs of the next step's ``poa_align`` call (a late
    step, so the graphs hold multi-predecessor nodes), its n_nodes, and its
    reads, read lengths, n_reads and fallback as the engine holds them."""
    from rattle_tpu_torch.correct import pack_engine as pe
    from rattle_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    n_reads = POA_CAPTURE_STEP + 1
    seqs = np.zeros((POA_LANES, n_reads, w), np.uint8)
    lens = np.zeros((POA_LANES, n_reads), np.int32)
    for li in range(POA_LANES):
        ref = rng.choice(_BASES, int(ref_len * rng.uniform(0.9, 1.0)))
        reads = sorted((mutate(rng, ref, 0.08)[:w - 2]
                        for _ in range(n_reads)), key=len, reverse=True)
        for t, r in enumerate(reads):
            seqs[li, t, :len(r)] = r
            lens[li, t] = len(r)
    st = pe._init_state(
        torch.from_numpy(seqs).to(dev), torch.from_numpy(lens).to(dev),
        torch.full((POA_LANES,), n_reads, dtype=torch.int32, device=dev),
        n_cap=n_cap, tot_cap=int(lens.sum(axis=1).max()))
    for t in range(POA_CAPTURE_STEP):
        pe._step(st, t, w_eff=w)
    check(int(st["fallback"].sum()) == 0, f"capture W={w}: a lane fell back")
    return [*pe.rank_space(st)] + [st[f] for f in (
        "n_nodes", "seqs", "lens", "n_reads", "fallback")]


def _poa_adversarial(dev, w: int, n_cap: int):
    """The adversarial graphs of utils/synth.poa_cases through the kernel
    and the plain version at width ``w``: exact."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.utils import synth
    cases = synth.poa_cases()
    b = len(cases)
    pred_rows = np.zeros((b, n_cap, kernels.POA_PMAX), np.int32)
    npred = np.ones((b, n_cap), np.int32)
    letters = np.zeros((b, n_cap), np.int32)
    n_nodes, seq_len, n_reads = (np.zeros(b, np.int32) for _ in range(3))
    seq = np.zeros((b, w), np.uint8)
    for li, (_name, g, read, act) in enumerate(cases):
        pr, npr, let, rank_nodes = synth.rank_arrays(g, n_cap)
        pred_rows[li], npred[li], letters[li] = pr, npr, let
        n_nodes[li] = len(rank_nodes)
        seq[li, :len(read)] = np.frombuffer(read.encode("ascii"), np.uint8)
        seq_len[li], n_reads[li] = len(read), act
    # a lone alignment: step 0, active while 0 < n_reads, no fallback
    args = [torch.from_numpy(x).to(dev) for x in
            (pred_rows, npred, letters, n_nodes, seq, seq_len)]
    args += [0, torch.from_numpy(n_reads).to(dev),
             torch.zeros(b, dtype=torch.int32, device=dev)]
    got = kernels.poa_align(*args)
    ref = kernels.poa_align_plain(*args)
    torch.cuda.synchronize()
    (packed, tlen, best), (r_packed, r_tlen, r_best) = got, ref
    for li, (name, *_rest) in enumerate(cases):
        cnt = int(r_tlen[li])
        check(int(best[li]) == int(r_best[li]) and int(tlen[li]) == cnt
              and torch.equal(packed[li, :cnt], r_packed[li, :cnt]),
              f"poa_align W={w}: adversarial case {name} differs")
    return {name: int(tlen[li]) for li, (name, *_r) in enumerate(cases)}


def phase_poa(dev):
    from rattle_tpu_torch.correct.pack_engine import CONFIGS
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.pipeline.profile_correct import REF_LENS
    rows = []
    for (w, n_cap, _lanes), ref_len in zip(CONFIGS, REF_LENS):
        group = _capture_step(dev, w, n_cap, ref_len, seed=w)
        # four more lanes: lane 0 with an empty graph, lane 1 past its last
        # read, lane 2 with a read unrelated to its graph, lane 3 fallen
        # back
        group = [torch.cat([x, x[:4]]) for x in group]
        pred_rows, npred, letters, n_nodes, seqs, lens, n_reads, fb = group
        t = POA_CAPTURE_STEP
        e, i, u, f = range(POA_LANES, POA_LANES + 4)
        n_nodes[e] = 0
        n_reads[i] = t
        fb[f] = 4
        g = torch.Generator(device=dev).manual_seed(w)
        slen_u = int(lens[u, t])
        seqs[u, t, :slen_u] = torch.tensor(
            list(b"ACGT"), dtype=torch.uint8, device=dev)[torch.randint(
                0, 4, (slen_u,), generator=g, device=dev)]
        # the read step as the engine calls it: the read and its length in
        # place in the pack's tensors, activity from (t, n_reads, fallback)
        args = [pred_rows, npred, letters, n_nodes, seqs[:, t, :w],
                lens[:, t], t, n_reads, fb]
        b = args[2].shape[0]
        scratch = torch.empty(kernels.poa_scratch_elems(b, n_cap, w),
                              dtype=torch.int16, device=dev)
        stamps = torch.zeros((b, 3), dtype=torch.int64, device=dev)
        got = kernels.poa_align(*args, scratch=scratch, stamps=stamps)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = kernels.poa_align_plain(*args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        (packed, tlen, best), (r_packed, r_tlen, r_best) = got, ref
        check(torch.equal(best, r_best), f"poa_align W={w}: best differs: "
              f"{best.tolist()} vs {r_best.tolist()}")
        check(torch.equal(tlen, r_tlen), f"poa_align W={w}: move count "
              f"differs: {tlen.tolist()} vs {r_tlen.tolist()}")
        counts = tlen.tolist()
        for li, cnt in enumerate(counts):
            check(torch.equal(packed[li, :cnt], r_packed[li, :cnt]),
                  f"poa_align W={w}: lane {li} moves differ")
        nn, sl = args[3].tolist(), args[5].tolist()
        check(all(counts[x] == 0 and best[x] == 0 for x in (e, i, f)),
              f"poa_align W={w}: an empty, finished or fallen-back lane "
              "produced moves")
        for li in range(POA_LANES):
            check(counts[li] > sl[li] // 2, f"poa_align W={w}: lane {li} "
                  f"aligned {counts[li]} of {sl[li]} bases")
        check(0 < counts[u] < counts[2], f"poa_align W={w}: unrelated read "
              f"aligned {counts[u]} bases")
        multi = sum(int((args[1][li, :nn[li]] > 1).sum())
                    for li in range(POA_LANES))
        check(multi > 0, f"poa_align W={w}: no multi-predecessor rank")
        ms = time_ms(lambda: kernels.poa_align(*args, scratch=scratch),
                     reps=5, warmup=1)
        live = [li for li in range(b) if nn[li] > 0 and li not in (i, f)]
        cells = sum(nn[li] * (sl[li] + 1) for li in live)
        nbytes = (sum(nn[li] * (kernels.POA_PMAX + 2) * 4 + sl[li]
                      for li in live) + 12 * b + 4 * sum(counts) + 8 * b)
        ops = cells * POA_OPS_PER_CELL
        t_ops, t_bytes = ops / PEAK_INT32, nbytes / PEAK_BYTES
        # the DP / traceback split of the lane that ended last
        st = stamps.tolist()
        slow = max(live, key=lambda li: st[li][2] - st[li][0])
        dp_ms = (st[slow][1] - st[slow][0]) / 1e6
        tb_ms = (st[slow][2] - st[slow][1]) / 1e6
        max_ranks = max(nn[li] for li in live)
        adv = _poa_adversarial(dev, w, n_cap) if w in (1024, 4096) else None
        row = dict(shape=[b, n_cap, w], ranks=nn, read_len=sl, moves=counts,
                   multi_pred_ranks=multi, cells=cells, ms=ms,
                   us_per_rank=ms * 1e3 / max_ranks,
                   dp_ms=dp_ms, traceback_ms=tb_ms,
                   slowest_lane=dict(lane=slow, ranks=nn[slow],
                                     moves=counts[slow]),
                   plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   max_abs_err=0, adversarial_moves=adv)
        print(f"  poa_align W={w} N={n_cap} lanes={b}: ranks {nn}, read "
              f"lengths {sl}, moves {counts}, {multi} multi-predecessor "
              f"ranks; kernel {ms:.3f} ms ({row['us_per_rank']:.3f} us a "
              f"rank over {max_ranks} ranks; slowest lane {slow}: DP "
              f"{dp_ms:.3f} ms, traceback {tb_ms:.3f} ms for {counts[slow]} "
              f"moves), plain {plain_ms:.1f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}, {cells} cells)"
              + (f"; adversarial cases exact, moves {adv}" if adv else ""))
        rows.append(row)
        del scratch
    print("phase 4 poa_align: best, move count and packed moves exact "
          "against the plain version at W = 1024, 2048, 4096 (captured read "
          f"step {POA_CAPTURE_STEP} as the engine calls it; empty-graph, "
          "finished, fallen-back and unrelated-read lanes) and on the "
          "adversarial graphs at W = 1024 and 4096")
    return rows


# phase 4b: letters of the adversarial reads beyond ACGT, each lane's own
_RARE = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
STEP_NAMES = ("pack", "pack", "pack", "pack", "idle_after_3", "empty",
              "unrelated", "node_cap", "pred_cap", "group_cap")
STEP_CAUSES = {"node_cap": 1, "pred_cap": 2, "group_cap": 4}


def _step_lanes(w: int, ref_len: int, seed: int):
    """The reads of phase 4b's group at width ``w``, one list a lane in
    STEP_NAMES order: four packs of 13 noisy copies of a transcript (long
    to short), a pack that goes idle after 3 reads, an empty lane, 3
    unrelated full-width ACGT reads (long runs of new nodes), and one lane
    for each fallback cause: 5 reads of w - 2 bases, each over two letters
    of its own (node cap 4 w: the fifth passes it), 18 reads whose first
    shared node takes a new predecessor from each (pred cap 16), 9 reads
    with a new letter at one aligned column (group cap 8)."""
    from rattle_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    packs = []
    for _ in range(5):
        ref = rng.choice(_BASES, int(ref_len * rng.uniform(0.9, 1.0)))
        packs.append(sorted((mutate(rng, ref, 0.08)[:w - 2]
                             for _ in range(13)), key=len, reverse=True))
    shared = rng.choice(_BASES, 20)
    left, right = rng.choice(_BASES, 15), rng.choice(_BASES, 15)
    return packs[:4] + [
        packs[4][:3], [],
        [rng.choice(_BASES, w - 2) for _ in range(3)],
        [rng.choice(_RARE[2 * i:2 * i + 2], w - 2) for i in range(5)],
        [np.concatenate([_RARE[i:i + 3], shared]) for i in range(18)],
        [np.concatenate([left, _RARE[i:i + 1], right]) for i in range(9)]]


def _clone_state(st: dict) -> dict:
    return {k: v.clone() for k, v in st.items()}


def _state_diff(got: dict, want: dict) -> list:
    """Fields of two states of one group that differ over their defined
    ranges: every node slot below N (the spare slot is left to the plain
    version), the path below its spare slot, the keys below n_nodes."""
    n = want["node_rank"].shape[1]
    bad = []
    for f, a in want.items():
        g = got[f]
        if f == "keys":
            live = (torch.arange(n, device=a.device)[None, :]
                    < want["n_nodes"][:, None])
            same = bool(((g[:, :n] == a[:, :n]) | ~live).all())
        elif f == "path":
            same = torch.equal(g[:, :-1], a[:, :-1])
        elif a.dim() >= 2 and a.shape[1] == n + 1:
            same = torch.equal(g[:, :n], a[:, :n])
        else:
            same = torch.equal(g, a)
        if not same:
            bad.append(f)
    return bad


def _step_pair(st: dict, t: int, w: int, scratch=None, **scores):
    """Read step ``t`` of a group: poa_align, then poa_thread and poa_rerank
    on ``st`` and their plain versions on a copy of it.  Returns (the
    alignment's outputs, the plain copy)."""
    from rattle_tpu_torch.correct import pack_engine as pe
    from rattle_tpu_torch.ops import kernels
    aligned = pe._align(st, t, w, scratch=scratch, **scores)
    plain = _clone_state(st)
    kernels.poa_thread(st, t, w, *aligned)
    kernels.poa_rerank(st)
    kernels.poa_thread_plain(plain, t, w, *aligned)
    kernels.poa_rerank_plain(plain)
    return aligned, plain


def _step_rows(dev, w: int, n_cap: int, lanes: int, ref_len: int):
    """poa_thread and poa_rerank at the main path's lane count of width
    ``w`` (the config's cap), on a group of noisy packs grown for
    STEP_CAPTURE read steps (profile_correct.grown_group), timed as lone
    calls and as launches queued back to back (device time a launch),
    beside their plain versions and their bounds (bytes of the live nodes
    and positions); poa_rerank's row also times torch.sort of the keys."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.pipeline.profile_correct import (grown_group,
                                                           step_rows)
    st, t, aligned = grown_group(dev, w, n_cap, lanes, ref_len)
    check(int(st["fallback"].sum()) == 0, f"phase 4b W={w}: a lane fell back")
    rows, done = step_rows(st, t, w, aligned)
    plain = _clone_state(st)
    ms_tp = time_ms(lambda: kernels.poa_thread_plain(plain, t, w, *aligned),
                    reps=1, warmup=0)
    ms_rp = time_ms(lambda: kernels.poa_rerank_plain(plain), reps=1,
                    warmup=0)
    check(not _state_diff(done, plain), f"phase 4b W={w}: timed "
          f"group differs: {_state_diff(done, plain)}")
    for row, plain_ms in zip(rows, (ms_tp, ms_rp)):
        row.update(shape=[lanes, n_cap, w], plain_ms=plain_ms,
                   library_ms=None, bound_by="bytes", max_abs_err=0)
        print(f"  {row['kernel']} W={w} N={n_cap} lanes={lanes} step {t}: "
              f"{row['nodes'][1]} nodes (largest lane {row['max_nodes']}),"
              f" {row['read_bases']} read bases; kernel {row['ms']:.4f} ms "
              f"lone, {row['device_ms']:.4f} ms device a launch, plain "
              f"{plain_ms:.2f} ms, bound {row['bound_ms']:.5f} ms (bytes, "
              f"{row['bytes']} B), {100 * row['share']:.2f}% of the bound"
              + (f"; torch.sort of the keys {row['sort_ms']:.4f} ms"
                 if row["sort_ms"] is not None else ""))
    return rows


def _sort_lanes() -> int:
    """poa_rerank's count of lanes ordered by its sort, on every card."""
    from rattle_tpu_torch.ops import kernels
    return sum(int(c.item()) for c in kernels.poa_rerank.sort_lanes.values())


def _reset_sort_lanes() -> None:
    from rattle_tpu_torch.ops import kernels
    for c in kernels.poa_rerank.sort_lanes.values():
        c.zero_()


# how phase 4b breaks the structure of one pack lane's keys, each failing
# poa_rerank's check: two old leaders at one group position, a negative key,
# two new groups' keys decreasing in id order
SORT_CASES = ("repeat_x", "negative", "decreasing_c")


def _sort_branch(st: dict, w: int) -> int:
    """poa_rerank on a copy of ``st`` whose keys break the structure on the
    first len(SORT_CASES) lanes (two old leaders' keys rewritten, so the
    leaders still take the first G positions), against its plain version,
    every field exact; the kernel's sort must order exactly those lanes.
    Returns the lanes it counted."""
    from rattle_tpu_torch.ops import kernels
    got = _clone_state(st)
    keys = got["keys"]
    n = got["node_rank"].shape[1]
    sk, half = kernels.POA_SK, kernels.POA_HALF
    # the kernels leave the keys from n_nodes on unwritten and read them as
    # BIG; the plain versions write and read BIG there
    keys.masked_fill_(torch.arange(n + 1, device=keys.device)[None, :]
                      >= got["n_nodes"][:, None], kernels.POA_BIG)
    for li, case in enumerate(SORT_CASES):
        k = keys[li, :n]
        old = torch.nonzero((k < kernels.POA_BIG) & (k % sk == half))
        check(len(old) >= 2, f"phase 4b W={w}: lane {li} has fewer than two "
              "old leaders")
        i, j = old.flatten()[:2].tolist()
        if case == "repeat_x":
            keys[li, j] = keys[li, i]
        elif case == "negative":
            keys[li, j] = -1
        else:
            x = int(keys[li, j]) // sk
            keys[li, i], keys[li, j] = x * sk + 1, x * sk
    want = _clone_state(got)
    _reset_sort_lanes()
    kernels.poa_rerank(got)
    kernels.poa_rerank_plain(want)
    bad = _state_diff(got, want)
    check(not bad, f"phase 4b W={w}: sort branch: {bad} differ from the "
          "plain version")
    sorted_lanes = _sort_lanes()
    check(sorted_lanes == len(SORT_CASES), f"phase 4b W={w}: the kernel "
          f"sorted {sorted_lanes} lanes, not the {len(SORT_CASES)} broken")
    return sorted_lanes


def phase_step(dev):
    """poa_thread and poa_rerank against their plain versions, every state
    field exact after every read step of an adversarial group at each width
    (``_step_lanes``: noisy packs, an idle and an empty lane, unrelated
    reads and one lane for each fallback cause, each cause checked; no lane
    may take poa_rerank's sort), then poa_rerank on the last state with the
    structure of its keys broken on three lanes (``_sort_branch``), then
    timed at the main path's lane counts."""
    from rattle_tpu_torch.correct.pack_engine import CONFIGS
    from rattle_tpu_torch.pipeline.profile_correct import (REF_LENS,
                                                           pack_group)
    rows = {}
    for (w, n_cap, lanes), ref_len in zip(CONFIGS, REF_LENS):
        lane_reads = _step_lanes(w, ref_len, seed=w + 2)
        st = pack_group(dev, lane_reads, w, n_cap)
        steps = st["seqs"].shape[1]
        _reset_sort_lanes()
        for t in range(steps):
            _aligned, plain = _step_pair(st, t, w)
            bad = _state_diff(st, plain)
            check(not bad, f"phase 4b W={w} step {t}: {bad} differ from the "
                  "plain versions")
        sorted_lanes = _sort_lanes()
        check(sorted_lanes == 0, f"phase 4b W={w}: poa_rerank sorted "
              f"{sorted_lanes} lanes of the group")
        fb = st["fallback"].tolist()
        nn = st["n_nodes"].tolist()
        for name, bit in STEP_CAUSES.items():
            li = STEP_NAMES.index(name)
            check(fb[li] == bit, f"phase 4b W={w}: lane {name} fell back "
                  f"with {fb[li]}, not {bit}")
        check(not any(fb[li] for li, nm in enumerate(STEP_NAMES)
                      if nm not in STEP_CAUSES),
              f"phase 4b W={w}: a lane fell back: {fb}")
        check(nn[STEP_NAMES.index("empty")] == 0,
              f"phase 4b W={w}: the empty lane grew")
        forced = _sort_branch(st, w)
        print(f"  poa_thread + poa_rerank W={w} N={n_cap}: {steps} steps of "
              f"{len(STEP_NAMES)} lanes {list(zip(STEP_NAMES, nn, fb))} "
              "(name, nodes, fallback): every field exact after every step, "
              f"sort_lanes {sorted_lanes}; keys broken on {forced} lanes "
              f"{SORT_CASES}: sort_lanes {forced}, every field exact")
        del st, plain
        rows[w] = _step_rows(dev, w, n_cap, lanes, ref_len)
        torch.cuda.empty_cache()
    print("phase 4b poa_thread + poa_rerank: every state field exact against "
          "the plain versions after every step at W = 1024, 2048, 4096 (noisy "
          "packs, idle, empty and unrelated-read lanes, each fallback cause; "
          "no lane sorted), and poa_rerank's sort exact on the lanes whose "
          "keys were broken")
    return rows


def _replay_groups(dev, cap) -> dict:
    """Every read step of each captured group again
    (profile_correct.replay_device_ms), poa_thread and poa_rerank against
    their plain versions on the same alignment: every state field exact
    after every step, at the group's own lane count; then the kernels'
    steps alone under the profiler, their device time summed over the
    steps beside the sum of each step's bound."""
    from rattle_tpu_torch.pipeline.profile_correct import replay_device_ms
    check(sorted(cap.groups) == WIDTHS,
          f"correct: no group captured at some width: {sorted(cap.groups)}")

    def check_step(st, t, w, scratch, scores):
        _aligned, plain = _step_pair(st, t, w, scratch, **scores)
        bad = _state_diff(st, plain)
        check(not bad, f"correct group W={st['seqs'].shape[2]} step {t}: "
              f"{bad} differ from the plain versions")

    return replay_device_ms(dev, cap, check=check_step)


def _cli(argv, capture: bool = False):
    from rattle_tpu_torch.pipeline import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf if capture else sys.stderr):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return buf.getvalue()


# the kernels a cluster run launches: the gate, the score path, the block
# replay and the sweep replay (a run of at most one block, k_block = 4,096
# reads, has no sweep: phases 7 and 8's small inputs); SCORE_PATH: the
# wave's kernels the plain-parity runs point at their plain versions
CLUSTER_KERNELS = ("gate_block", "lis_filter", "join_expand", "score_decide",
                   "greedy_owner", "absorb_rest")
BLOCK_KERNELS = CLUSTER_KERNELS[:-1]
SCORE_PATH = ("gate_block", "join_expand", "score_decide", "greedy_owner",
              "absorb_rest")
# cudaLaunchKernel calls each 8,192-read cluster run should stay below
LAUNCH_TARGETS = {"rna": 60_000, "cdna": 110_000}


def _counted(argv):
    """Run one CLI mode with every launch count set to 0 just before it and
    the run's metrics cleared; returns (wall seconds, this run's launches)."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.utils import metrics
    metrics.GLOBAL.stages.clear()
    metrics.GLOBAL.counters.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _cli(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, kernels.launches()


def _host_rescores() -> int:
    from rattle_tpu_torch.utils import metrics
    return int(metrics.GLOBAL.counters.get("cluster.host_rescores", 0))


def _wave_reads(label: str, flags) -> dict:
    """The last cluster run's device->host reads (cluster/bulk.py counts
    them): the waves, the reads of their fixed schedule, the most of them in
    one wave, and the rare paths' reads apart.  Checks the engine's rule:
    at most two reads a strand and one a wave outside the rare paths."""
    from rattle_tpu_torch.utils import metrics
    c = metrics.GLOBAL.counters
    res = {k: int(c.get("cluster." + k, 0))
           for k in ("waves", "host_reads", "rare_reads", "wave_reads_max")}
    strands = 1 if "--rna" in flags else 2
    check(res["waves"] > 0 and res["wave_reads_max"] <= 1 + 2 * strands,
          f"{label}: {res['wave_reads_max']} host reads in one wave, the "
          f"rule allows {1 + 2 * strands} ({res})")
    res["reads_a_wave"] = res["host_reads"] / res["waves"]
    return res


@contextlib.contextmanager
def _plain_score_path():
    """cluster/bulk.py's wave kernels (SCORE_PATH: the gate, the score path
    and both replays) pointed at their plain versions for the duration of
    the block: a switch of this script only, not of the package."""
    from rattle_tpu_torch.ops import kernels
    with _bulk_names(**{k: getattr(kernels, k + "_plain")
                        for k in SCORE_PATH}):
        yield


def _main_run(label, reads, flags, plain: bool = False):
    """Cluster ``reads`` on cuda; every read must land in one cluster and
    every cluster kernel must have launched in this run, bv_common never
    (its product runs inside gate_block: no [A, C] count matrix is written),
    and the engine's host reads must keep its rule (``_wave_reads``).  With
    ``plain`` the wave runs its plain versions (``_plain_score_path``), and
    none of their kernels may launch."""
    from rattle_tpu_torch.io import hpsio
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.utils import metrics
    from rattle_tpu_torch.utils.synth import write_fastq
    fq = os.path.join(WORK, f"{label}.fq")
    out = os.path.join(WORK, f"{label}_out")
    os.makedirs(out)
    write_fastq(reads, fq)
    torch.cuda.reset_peak_memory_stats()
    with _plain_score_path() if plain else contextlib.nullcontext():
        wall, launches = _counted(["cluster", "-i", fq, "-o", out, *flags])
    need = [k for k in CLUSTER_KERNELS if not (plain and k in SCORE_PATH)]
    check(all(launches[k] for k in need),
          f"{label}: a kernel never ran: {launches}")
    check(not plain or not any(launches[k] for k in SCORE_PATH),
          f"{label}: a score-path kernel ran in the plain run: {launches}")
    check(launches["bv_common"] == 0, f"{label}: bv_common launched "
          f"{launches['bv_common']} times on the cluster path")
    reads_ = _wave_reads(label, flags)
    clusters = hpsio.read_clusters(os.path.join(out, "clusters.out"))
    members = [s.seq_id for c in clusters for s in c.seqs]
    check(sorted(members) == list(range(len(reads))),
          f"{label}: not every read is in exactly one cluster")
    fam = np.array([f for _n, _s, f in reads])
    pure = sum(np.bincount(fam[[s.seq_id for s in c.seqs]]).max()
               for c in clusters)
    st = metrics.GLOBAL.stages
    res = dict(flags=flags, reads=len(reads), clusters=len(clusters),
               purity=pure / len(reads), cluster_s=wall,
               reads_per_s=len(reads) / wall,
               greedy_s=st.get("cluster.greedy"),
               merge_s=st.get("cluster.merge"),
               sections_s={k[8:]: v for k, v in st.items()
                           if k[8:].split("_")[0] in ("gate", "score",
                                                      "rescore", "replay")},
               host_reads=reads_,
               host_rescores=_host_rescores(), launches=launches,
               lis_shapes={f"M={m} B={b}": n for (m, b), n in
                           sorted(kernels.lis_filter.shapes.items())},
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  {label} ({' '.join(flags) or 'cDNA'}): {len(clusters)} clusters,"
          f" purity {res['purity']:.4f}; cluster {wall:.2f} s "
          f"({res['reads_per_s']:.1f} reads/s: greedy {res['greedy_s']:.2f} s,"
          f" merge {res['merge_s']:.2f} s; sections "
          f"{ {k: round(v, 3) for k, v in res['sections_s'].items()} }), "
          f"host reads: {reads_['host_reads']} in {reads_['waves']} waves "
          f"({reads_['reads_a_wave']:.2f} a wave, at most "
          f"{reads_['wave_reads_max']}), {reads_['rare_reads']} on rare "
          f"paths; {res['host_rescores']} host rescores, peak "
          f"{res['peak_mem_gib']:.2f} GiB, launches {launches}")
    print(f"  {label} lis_filter launches by (M, B): {res['lis_shapes']}")
    return res, fq, os.path.join(out, "clusters.out")


def _api_launches(label, fq, flags) -> dict:
    """The same cluster run again, under torch.profiler: its CUDA runtime
    launch calls (cudaLaunchKernel and the like) beside the run's target,
    its synchronising calls (cudaStreamSynchronize, cudaMemcpyAsync: calls
    and host seconds) and device-to-host copies, device busy time and idle
    share."""
    from rattle_tpu_torch.pipeline.profile_cluster import profiled_launches
    out = os.path.join(WORK, f"{label}_profiled")
    os.makedirs(out)
    res = profiled_launches(lambda: _cli(["cluster", "-i", fq, "-o", out,
                                          *flags]))
    res["target"] = LAUNCH_TARGETS[label]
    print(f"  {label}: {res['launch_calls']} CUDA launch calls "
          f"({'below' if res['launch_calls'] < res['target'] else 'ABOVE'} "
          f"the target {res['target']}; by call {res['by_call']}), "
          f"synchronising calls {res['syncs']}, device "
          f"busy {res['device_busy_s']:.3f} s of {res['wall_s']:.3f} s "
          f"profiled, idle share {res['idle_share']:.3f}")
    return res


def _plain_parity(label, reads, flags, clusters_out):
    """``cluster`` again with the score path on its plain versions: its
    clusters.out must equal the kernel run's byte for byte."""
    res = _main_run(f"{label}_plain", reads, flags, plain=True)
    _same_files(os.path.dirname(res[2]), os.path.dirname(clusters_out),
                ("clusters.out",), f"{label} plain score path")
    print(f"  {label}: clusters.out byte-identical with the score path on "
          f"its plain versions ({res[0]['cluster_s']:.2f} s)")
    return res[0]


def phase_main_path():
    """``cluster --rna`` (the main path, then ``cluster_summary`` and
    ``extract_clusters`` on its output) and ``cluster`` in cDNA mode (both
    strands), each on 8,192 reads with its own launch counts, then each
    again under the profiler (CUDA launch calls) and with the score path on
    its plain versions (clusters.out byte for byte)."""
    from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                              MAIN_SEED, synthetic_reads)
    reads = synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED)
    rna, fq, clusters_out = _main_run("rna", reads, ["--rna"])
    t1 = time.perf_counter()
    rows = _cli(["cluster_summary", "-i", fq, "-c", clusters_out],
                capture=True)
    check(len(rows.splitlines()) == MAIN_READS, "cluster_summary row count")
    ext = os.path.join(WORK, "extract")
    os.makedirs(ext)
    _cli(["extract_clusters", "-i", fq, "-c", clusters_out, "-o", ext])
    check(len(os.listdir(ext)) == rna["clusters"], "extract_clusters files")
    rna["summary_extract_s"] = time.perf_counter() - t1
    print(f"  rna: cluster_summary + extract_clusters "
          f"{rna['summary_extract_s']:.2f} s")
    reads_c = synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED,
                              revcomp=True)
    cdna, fq_c, clusters_c = _main_run("cdna", reads_c, [])
    iso, _fq_i, clusters_i = _main_run("iso", reads, ["--rna", "--iso"])
    rna["profiled"] = _api_launches("rna", fq, ["--rna"])
    cdna["profiled"] = _api_launches("cdna", fq_c, [])
    rna["plain_score_path"] = _plain_parity("rna", reads, ["--rna"],
                                            clusters_out)
    cdna["plain_score_path"] = _plain_parity("cdna", reads_c, [], clusters_c)
    iso["plain_score_path"] = _plain_parity("iso", reads, ["--rna", "--iso"],
                                            clusters_i)
    print(f"phase 5 main path: cluster --rna, cDNA cluster and cluster --rna "
          f"--iso on {MAIN_READS} reads of {MAIN_FAMILIES} families on cuda, "
          "every read in one cluster, every cluster kernel launched in each "
          f"run and bv_common in none ({rna['profiled']['launch_calls']} / "
          f"{cdna['profiled']['launch_calls']} CUDA launch calls in --rna / "
          "cDNA; host reads a wave "
          f"{rna['host_reads']['reads_a_wave']:.2f} / "
          f"{cdna['host_reads']['reads_a_wave']:.2f} / "
          f"{iso['host_reads']['reads_a_wave']:.2f}, at most "
          f"{rna['host_reads']['wave_reads_max']} / "
          f"{cdna['host_reads']['wave_reads_max']} / "
          f"{iso['host_reads']['wave_reads_max']}), clusters.out "
          "byte-identical with the wave on its plain versions; peak device "
          "memory "
          f"{rna['peak_mem_gib']:.2f} / {cdna['peak_mem_gib']:.2f} / "
          f"{iso['peak_mem_gib']:.2f} GiB")
    return dict(rna=rna, cdna=cdna, iso=iso), fq, clusters_out


def _fastq_count(path: str) -> int:
    from rattle_tpu_torch.io import fastx
    return len(fastx.read_fastq_plain(path))


def _poa_run(argv):
    """One ``correct`` or ``polish`` run on cuda: (wall seconds, launches,
    the pack engine's statistics of this run)."""
    from rattle_tpu_torch.correct import runner
    for k in list(runner.LAST_STATS):
        runner.LAST_STATS[k] = 0
    wall, launches = _counted(argv)
    return wall, launches, dict(runner.LAST_STATS)


def _fmt_stats(st: dict) -> str:
    fb = {k: v for k, v in st.items() if k.startswith("fb_")}
    secs = {k: st.get(k, 0.0) for k in ("t_fill_s", "t_steps_s", "t_fetch_s",
                                        "t_decode_s", "host_wait_s")}
    return (f"{st['steps']} steps; device {st['device_packs']} packs / "
            f"{st['device_bases']} bases, host {st['fallback_packs']} packs "
            f"/ {st['host_bases']} bases {fb}; engine {secs}")


def phase_correct(fq: str, clusters_out: str, n_reads: int):
    """``correct`` on the main path's reads and clusters, then ``polish`` on
    its consensi, both through the CLI on cuda."""
    from rattle_tpu_torch.correct.pack_engine import _cfg_for
    from rattle_tpu_torch.io import fastx, hpsio
    from rattle_tpu_torch.pipeline.profile_correct import (GroupCapture,
                                                           capturing_groups)
    clusters = hpsio.read_clusters(clusters_out)
    reads = fastx.read_multiple_inputs([fq], [])
    # packs the run will form (build_packs: split 200, min_reads 5)
    widths = {}
    with_pack = 0
    biggest = 0
    for c in clusters:
        n_files = (len(c.seqs) - 1) // 200 + 1
        sizes = [len(c.seqs[nf::n_files]) for nf in range(n_files)]
        with_pack += any(sz > 5 for sz in sizes)
        for nf, sz in enumerate(sizes):
            if sz > 5:
                lmax = max(len(reads[s.seq_id].seq)
                           for s in c.seqs[nf::n_files])
                w = _cfg_for(lmax, sz)[0]
                widths[w] = widths.get(w, 0) + 1
                biggest = max(biggest, sz)
    check(sorted(widths) == WIDTHS,
          f"correct: packs do not cover the three widths: {widths}")

    out = os.path.join(WORK, "correct_out")
    os.makedirs(out)
    torch.cuda.reset_peak_memory_stats()
    cap = GroupCapture()
    _reset_sort_lanes()
    with capturing_groups(cap):
        wall, launches, st = _poa_run(["correct", "-i", fq, "-c",
                                       clusters_out, "-o", out])
    sorted_lanes = _sort_lanes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_corr = _fastq_count(os.path.join(out, "corrected.fq"))
    n_unc = _fastq_count(os.path.join(out, "uncorrected.fq"))
    n_cons = _fastq_count(os.path.join(out, "consensi.fq"))
    check(n_corr + n_unc == n_reads, f"correct: {n_corr} corrected + {n_unc} "
          f"uncorrected != {n_reads} reads")
    check(n_cons == with_pack, f"correct: {n_cons} consensi for {with_pack} "
          "clusters with a pack")
    check(launches["poa_align"] > 0 and st["device_packs"] > 0,
          f"correct: the pack engine never ran: {launches} {st}")
    check(launches["poa_align"] == launches["poa_thread"]
          == launches["poa_rerank"] == st["steps"],
          f"correct: not one launch of each step kernel a read step "
          f"({st['steps']} steps): {launches}")
    bases = st["device_bases"] + st["host_bases"]
    res = dict(reads=n_reads, packs_by_width=widths, largest_pack=biggest,
               corrected=n_corr, uncorrected=n_unc, consensi=n_cons,
               correct_s=wall, poa_mbases_per_s=bases / 1e6 / wall,
               peak_mem_gib=peak, launches=launches, stats=st,
               t_steps_s=st.get("t_steps_s"), sort_lanes=sorted_lanes)
    print(f"  correct: {n_corr} corrected + {n_unc} uncorrected reads, "
          f"{n_cons} consensi; packs by width {widths}, largest "
          f"{biggest} reads; {wall:.2f} s, t_steps_s {res['t_steps_s']}, "
          f"{res['poa_mbases_per_s']:.4f} Mbases/s aligned, peak "
          f"{peak:.2f} GiB, launches {launches}, poa_rerank sort_lanes "
          f"{sorted_lanes} (lanes ordered by its sort, not by counting)")
    print(f"  correct engine: {_fmt_stats(st)}")
    # the kernels held to their plain versions on the run's own groups
    groups = _replay_groups(torch.device("cuda"), cap)
    del cap
    res["captured_groups"] = groups
    print("  poa_thread + poa_rerank on the run's largest group at each "
          "width, every field exact after every step; device time summed "
          "over its steps against the summed bound:")
    for w, g in groups.items():
        print(f"    W={w}: {g['lanes']} lanes x {g['steps']} steps, "
              f"{g['nodes']} nodes (largest lane {g['max_nodes']}), "
              f"{g['fallback_lanes']} lanes fallen back, {g['traces']} "
              f"trace(s) taken; " + "; ".join(
                  f"{k} {g[k]['device_ms']:.3f} ms, bound "
                  f"{g[k]['bound_ms']:.3f} ms ({100 * g[k]['share']:.1f}%)"
                  for k in ("poa_thread", "poa_rerank")))
    # the same run under the profiler: the CUDA runtime's launch calls
    from rattle_tpu_torch.pipeline.profile_cluster import profiled_launches
    out_p = os.path.join(WORK, "correct_profiled")
    os.makedirs(out_p)
    prof = profiled_launches(lambda: _cli(["correct", "-i", fq, "-c",
                                           clusters_out, "-o", out_p]))
    res["profiled"] = prof
    print(f"  correct profiled: {prof['launch_calls']} CUDA launch calls "
          f"({prof['launch_calls'] / st['steps']:.2f} a read step; by call "
          f"{prof['by_call']}), device busy {prof['device_busy_s']:.3f} s of "
          f"{prof['wall_s']:.3f} s, idle share {prof['idle_share']:.3f}")

    pout = os.path.join(WORK, "polish_out")
    os.makedirs(pout)
    wall_p, launches_p, st_p = _poa_run(
        ["polish", "-i", os.path.join(out, "consensi.fq"), "-o", pout,
         "--rna", "--summary"])
    n_tx = _fastq_count(os.path.join(pout, "transcriptome.fq"))
    check(1 <= n_tx <= n_cons, f"polish: {n_tx} transcripts from {n_cons} "
          "consensi")
    check(os.path.exists(os.path.join(pout, "polish_summary.tsv")),
          "polish: no polish_summary.tsv")
    check(all(launches_p[k] for k in BLOCK_KERNELS),
          f"polish: a cluster kernel never ran: {launches_p}")
    res["polish"] = dict(transcripts=n_tx, polish_s=wall_p,
                         launches=launches_p, stats=st_p)
    print(f"  polish: {n_tx} transcripts from {n_cons} consensi; "
          f"{wall_p:.2f} s, launches {launches_p}")
    print(f"  polish engine: {_fmt_stats(st_p)}")
    print(f"phase 6 correct path: correct on {n_reads} reads ({wall:.1f} s, "
          f"t_steps_s {res['t_steps_s']}, {prof['launch_calls']} CUDA launch "
          f"calls) and polish --rna --summary ({wall_p:.1f} s) on cuda; every "
          "read accounted for, one consensus per cluster with a pack, "
          "poa_align, poa_thread and poa_rerank launched once a read step "
          "and exact on every step of the largest group at each width")
    return res


# --------------------------------------------------------------------------
# phase 6c: the lockstep runner (RATTLE_POA_BACKEND=lockstep) and its kernel
# --------------------------------------------------------------------------

CORRECT_FILES = ("corrected.fq", "uncorrected.fq", "consensi.fq")
# phase 6c's lockstep run takes a seed-fixed share of the main path's
# clusters (the whole run, ~170 s on an H100, would take the script past
# 1.5x its earlier time), with every l_cap class and the largest pack
LOCKSTEP_SHARE = 0.35
LOCKSTEP_SEED = 12


def _lockstep_subset(fq: str, clusters_out: str):
    """clusters.out of a seed-fixed LOCKSTEP_SHARE of the clusters, plus the
    cluster of the largest pack and one cluster of each l_cap class
    (round_pow2(longest read + 1, 128)) that some pack of the whole set
    has; returns (path, record)."""
    from rattle_tpu_torch.correct.runner import _round_pow2
    from rattle_tpu_torch.io import fastx, hpsio
    clusters = hpsio.read_clusters(clusters_out)
    reads = fastx.read_multiple_inputs([fq], [])
    info = []
    for c in clusters:
        # the packs correct forms (build_packs: split 200, min_reads 5)
        n_files = (len(c.seqs) - 1) // 200 + 1
        packs = [c.seqs[nf::n_files] for nf in range(n_files)]
        packs = [pk for pk in packs if len(pk) > 5]
        caps = {_round_pow2(max(len(reads[x.seq_id].seq) for x in pk) + 1,
                            128) for pk in packs}
        info.append((caps, max((len(pk) for pk in packs), default=0)))
    rng = np.random.default_rng(LOCKSTEP_SEED)
    keep = set(np.flatnonzero(rng.random(len(clusters))
                              < LOCKSTEP_SHARE).tolist())
    largest = max(range(len(clusters)), key=lambda i: info[i][1])
    keep.add(largest)
    every = sorted(set().union(*(caps for caps, _ in info)))
    for cap in every:
        if not any(cap in info[i][0] for i in keep):
            keep.add(next(i for i, (caps, _) in enumerate(info)
                          if cap in caps))
    sub = [clusters[i] for i in sorted(keep)]
    path = os.path.join(WORK, "lockstep_subset", "clusters.out")
    os.makedirs(os.path.dirname(path))
    hpsio.write_clusters(sub, path)
    return path, dict(clusters=len(sub), of=len(clusters),
                      reads=sum(len(c.seqs) for c in sub),
                      l_caps=every, largest_pack=info[largest][1])


def _lockstep_correct(label: str, fq: str, clusters_out: str,
                      capture: bool = False):
    """``correct`` on cuda with RATTLE_POA_BACKEND=lockstep: (output
    directory, the run's record, the captured steps or None)."""
    from rattle_tpu_torch.pipeline import profile_lockstep
    out = os.path.join(WORK, f"{label}_lockstep")
    os.makedirs(out)
    with profile_lockstep.backend("lockstep"), \
            profile_lockstep.capture() as (made, steps):
        wall, launches, st = _poa_run(["correct", "-i", fq, "-c",
                                       clusters_out, "-o", out])
    check(len(made) == 1, f"{label}: {len(made)} lockstep runners")
    ls = dict(made[0].stats)
    check(not any(launches[k] for k in ("poa_align", "poa_thread",
                                        "poa_rerank")),
          f"{label} lockstep: the pack engine ran: {launches}")
    check(ls["device_packs"] > 0,
          f"{label} lockstep: no pack on the card: {ls}")
    check(launches["poa_align_batch"] == ls["steps"] == st["steps"] > 0,
          f"{label} lockstep: not one launch a read step: {launches} {ls}")
    run = dict(correct_s=wall, launches=launches, stats=ls)
    return out, run, (steps if capture else None)


def _batch_bound(args, moves: int):
    """The least time poa_align_batch could take on these inputs, reckoned
    as poa_align's: the larger of POA_OPS_PER_CELL int32 operations a DP
    cell (n_nodes x (seq_len + 1) a lane) at PEAK_INT32 and the bytes the
    function must move at PEAK_BYTES, each lane's live inputs read once (a
    letter and its predecessor slots a rank, the read, n_nodes and
    seq_len) and its outputs written once (the ``moves`` packed moves
    emitted, length and aligned): (bound ms, bound_by)."""
    letters, preds, n_nodes, seq, seq_len = args
    nn = n_nodes.to(torch.int64)
    sl = seq_len.to(torch.int64)
    rank_bytes = letters.element_size() \
        + preds.shape[2] * preds.element_size()
    nbytes = (int((nn * rank_bytes + sl).sum())
              + letters.shape[0] * (n_nodes.element_size()
                                    + seq_len.element_size() + 4 + 1)
              + 4 * moves)
    ops = int((nn * (sl + 1)).sum()) * POA_OPS_PER_CELL
    t_ops, t_bytes = ops / PEAK_INT32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _native_correct(label: str, fq: str, clusters_out: str):
    """Start ``correct`` on cuda (the CLI's default, as a user runs it)
    with RATTLE_POA_BACKEND=native (every pack on the host aligner: the
    runner on the card, no kernel launched) in a process of its own beside
    the card's phases; returns (process, output directory, start time)."""
    out = os.path.join(WORK, f"{label}_native")
    os.makedirs(out)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rattle_tpu_torch.pipeline.cli", "correct",
         "-i", fq, "-c", clusters_out, "-o", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           RATTLE_POA_BACKEND="native"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc, out, time.perf_counter()


def _lockstep_kernel_rows(dev, steps) -> dict:
    """poa_align_batch against its plain version, exactly, on the captured
    step of each width with the added lanes (profile_lockstep.kernel_row:
    predecessors as the runner gives them, int16, and as int32; the empty
    and idle lanes emit nothing), timed as lone calls beside the plain
    version and the bound."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.pipeline.profile_lockstep import (WIDTHS,
                                                            extra_lanes,
                                                            kernel_row)
    check(set(WIDTHS) <= set(steps),
          f"lockstep: no step captured at some width: {sorted(steps)}")
    rows = {}
    for w in WIDTHS:
        args, extra = extra_lanes(steps[w][1], dev, seed=w)
        row = kernel_row(args, extra)
        bound_ms, bound_by = _batch_bound(args, sum(row["moves"]))
        row.update(bound_ms=bound_ms, bound_by=bound_by,
                   share=bound_ms / row["ms"], library_ms=None)
        rows[w] = row
        b, n, _ = row["shape"]
        print(f"  poa_align_batch W={w} N={n} lanes={b} "
              f"({'int16' if w <= kernels.POA_SMALL_L else 'int32'} cells): "
              f"ranks {row['ranks']}, read lengths {row['read_len']}, moves "
              f"{row['moves']}; kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.1f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}, {row['cells']} cells, "
              f"{100 * bound_ms / row['ms']:.2f}%)")
    return rows


def phase_lockstep(fq: str, clusters_out: str, engine_s: float,
                   parity_fq: str, parity_clusters: str):
    """Phase 6c: ``correct`` with RATTLE_POA_BACKEND=lockstep on a
    seed-fixed subset of phase 6's clusters (``_lockstep_subset``), byte for
    byte the pack engine's on the same subset; poa_align_batch held to its
    plain version on the run's largest step at each width; lockstep, and
    native in a process of its own, on phase 7's rna parity reads (held to
    the host path with phase 7's runs).  Returns (record, {label: {backend:
    output directory, or (process, directory, start) while it runs}})."""
    dev = torch.device("cuda")
    sub, cut = _lockstep_subset(fq, clusters_out)
    native = _native_correct("parity_correct_rna", parity_fq,
                             parity_clusters)
    eng_out = os.path.join(WORK, "lockstep_subset", "engine")
    os.makedirs(eng_out)
    wall_e, _launches, st_e = _poa_run(["correct", "-i", fq, "-c", sub, "-o",
                                        eng_out])
    torch.cuda.reset_peak_memory_stats()
    out, run, steps = _lockstep_correct("lockstep_subset/correct", fq, sub,
                                        capture=True)
    run["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _same_files(out, eng_out, CORRECT_FILES,
                "correct lockstep vs the pack engine")
    run.update(subset=cut, engine_s=wall_e, engine_stats=st_e,
               engine_full_s=engine_s)
    ls = run["stats"]
    n = max(ls["steps"], 1)
    print(f"  lockstep subset: {cut['clusters']} of {cut['of']} clusters "
          f"(seed {LOCKSTEP_SEED}, share {LOCKSTEP_SHARE}), {cut['reads']} "
          f"reads, l_cap classes {cut['l_caps']}, largest pack "
          f"{cut['largest_pack']} reads")
    print(f"  correct lockstep: {run['correct_s']:.2f} s (align "
          f"{ls['t_align_s']:.2f} s in {ls['steps']} read steps, "
          f"{1e3 * ls['t_align_s'] / n:.2f} ms a step; host "
          f"{ls['t_host_s']:.2f} s, {1e3 * ls['t_host_s'] / n:.2f} ms a "
          f"step; host aligner {ls['t_fallback_s']:.2f} s); device "
          f"{ls['device_packs']} packs / {ls['device_bases']} bases, host "
          f"{ls['fallback_packs']} packs / {ls['host_bases']} bases; peak "
          f"{run['peak_mem_gib']:.2f} GiB; byte-identical to the pack "
          f"engine on the subset ({wall_e:.2f} s, {_fmt_stats(st_e)}; "
          f"phase 6, every cluster: {engine_s:.2f} s)")
    run["kernel_rows"] = _lockstep_kernel_rows(dev, steps)
    p_out, p_run, _ = _lockstep_correct("parity_correct_rna", parity_fq,
                                        parity_clusters)
    run["parity_lockstep"] = p_run
    print(f"  parity correct rna lockstep: {p_run['correct_s']:.2f} s, "
          f"{p_run['stats']}")
    print(f"phase 6c lockstep: correct with RATTLE_POA_BACKEND=lockstep on "
          f"{cut['clusters']} of phase 6's {cut['of']} clusters "
          f"({run['correct_s']:.1f} s, {ls['steps']} poa_align_batch "
          "launches) byte-identical to the pack engine's; poa_align_batch "
          "exact against its plain version at W = 1024, 2048, 4096 on the "
          "run's largest steps with empty, unrelated, past-the-graph and "
          "idle lanes; "
          "lockstep and native on the rna parity reads (held to the host "
          "path with phase 7)")
    return run, {"rna": {"lockstep": p_out, "native": native}}


def _same_files(a: str, b: str, names, what: str) -> None:
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            check(fa.read() == fb.read(), f"parity {what}: {name} differs")


# processes this script started; main() stops any still running at its end
_CHILDREN = []


def _host_correct(label: str, fq: str, clusters_out: str):
    """Start ``correct --poa-backend host`` (the Python POA oracle, one CPU
    core for a minute or two on 256 reads) in a process of its own, so that
    it runs beside the card's phases; returns (process, output directory,
    start time)."""
    out = os.path.join(WORK, f"parity_correct_{label}_host")
    os.makedirs(out)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rattle_tpu_torch.pipeline.cli", "correct",
         "-i", fq, "-c", clusters_out, "-o", out, "--poa-backend", "host"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc, out, time.perf_counter()


def _device_correct(label: str, fq: str, clusters_out: str):
    """``correct`` on cuda: every pack on the card."""
    out = os.path.join(WORK, f"parity_correct_{label}_cuda")
    os.makedirs(out)
    wall, launches, st = _poa_run(["correct", "-i", fq, "-c", clusters_out,
                                   "-o", out])
    check(launches["poa_align"] > 0 and launches["poa_thread"] > 0,
          f"parity correct {label}: the step kernels never ran: {launches}")
    check(st["fallback_packs"] == 0, f"parity correct {label}: packs on the "
          f"host aligner in the device run: {_fmt_stats(st)}")
    return out, dict(correct_s=wall, launches=launches, stats=st)


def _finish_parity(pending: dict, extra: dict) -> dict:
    """Wait for the host ``correct`` runs of phase 7 and hold each device
    run's three files to them byte for byte, and phase 6c's runs in
    ``extra`` ({label: {backend: directory, or (process, directory,
    start)}}) too."""
    res = {}
    for label, (proc, host_out, t0, cuda_out, run) in pending.items():
        _, err = proc.communicate(timeout=HOST_CORRECT_S)
        check(proc.returncode == 0, f"parity correct {label}: the host run "
              f"exited {proc.returncode}: {err[-2000:]}")
        _same_files(cuda_out, host_out, CORRECT_FILES, f"correct {label}")
        for backend, out in extra.get(label, {}).items():
            if isinstance(out, tuple):
                bproc, out, bt0 = out
                _, berr = bproc.communicate(timeout=HOST_CORRECT_S)
                check(bproc.returncode == 0 and f"POA packs ({backend}):"
                      in berr, f"parity correct {label} {backend}: exited "
                      f"{bproc.returncode}: {berr[-2000:]}")
                run[f"correct_{backend}_s"] = time.perf_counter() - bt0
            _same_files(out, host_out, CORRECT_FILES,
                        f"correct {label} {backend}")
        run["correct_host_s"] = time.perf_counter() - t0
        res[label] = run
        print(f"  parity correct {label}: byte-identical to the host path "
              f"(cuda {run['correct_s']:.2f} s, {_fmt_stats(run['stats'])}; "
              f"host oracle done {run['correct_host_s']:.1f} s after its "
              "start, beside the other phases)")
    print(f"phase 7 correct parity: correct on the {', '.join(res)} parity "
          "clusters matches --poa-backend host byte for byte, and so do "
          f"the lockstep and native runs on {', '.join(extra)}")
    return res


def _parity_polish(cuda_out: str):
    """``polish`` on cuda against ``polish --oracle --poa-backend host`` on
    the same consensi: byte-identical transcriptomes."""
    fq = os.path.join(cuda_out, "consensi.fq")
    dirs = {k: os.path.join(WORK, f"parity_polish_{k}")
            for k in ("cuda", "host")}
    for d in dirs.values():
        os.makedirs(d)
    wall_p, _, _ = _poa_run(["polish", "-i", fq, "-o", dirs["cuda"],
                             "--rna"])
    wall_ph, _, _ = _poa_run(["polish", "-i", fq, "-o", dirs["host"],
                              "--rna", "--oracle", "--poa-backend", "host"])
    _same_files(dirs["cuda"], dirs["host"], ("transcriptome.fq",), "polish")
    print(f"  parity polish: byte-identical to the host path (cuda "
          f"{wall_p:.2f} s, host {wall_ph:.2f} s)")
    return dict(polish_s=wall_p, polish_host_s=wall_ph)


def _capacity_fallback():
    """A pack with reads over the widest config's 4,094 bases goes to the
    host aligner, counted by cause, beside a pack that runs on the card."""
    from rattle_tpu_torch.correct import runner
    from rattle_tpu_torch.correct.pack_engine import PackEngine
    from rattle_tpu_torch.ops import poa
    from rattle_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(3)
    ref = rng.choice(_BASES, 4400)
    long_pack = sorted((mutate(rng, ref, 0.05).tobytes().decode("ascii")
                        for _ in range(3)), key=len, reverse=True)
    check(len(long_pack[0]) > 4094, "fallback: the long read is too short")
    short_pack = [s[:600] for s in long_pack]
    params = poa.POAParams()
    eng = PackEngine(device="cuda")
    rows = runner.batched_msa([long_pack, short_pack], params, eng)
    st = eng.stats
    check(st["fb_length"] == 1 and st["fallback_packs"] == 1
          and st["device_packs"] == 1, f"fallback: wrong accounting: {st}")
    check(rows[0] == runner._host_msa(long_pack, params),
          "fallback: the long pack's rows are not the host aligner's")
    check(rows[1] == poa.poa_msa(short_pack, params),
          "fallback: the device pack's rows are not the oracle's")
    print(f"  capacity fallback: a pack of {len(long_pack[0])}-base reads "
          "ran on the host aligner (fb_length 1) beside a device pack")


@contextlib.contextmanager
def _bulk_names(**values):
    """Set names of cluster/bulk.py for the duration of the block: module
    constants (read when an engine is built) or the kernels it calls."""
    from rattle_tpu_torch.cluster import bulk
    saved = {k: getattr(bulk, k) for k in values}
    for k, v in values.items():
        setattr(bulk, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(bulk, k, v)


# each forces one of the engine's rare paths on every pair it concerns:
# a variance band so wide that every score-passing pair is borderline, and
# a one-tier M ladder, so every pair over 128 matches overflows
FORCED_RESCORES = (("all_borderline", dict(VAR_BAND_REL=1e12)),
                   ("overflow_m128", dict(M_LADDER=(128,))))


def _forced_rescores(fq: str, oracle_out: str):
    """``cluster --rna`` on cuda with a rare path forced: clusters.out byte
    for byte the oracle's, host rescores > 0, lis_filter launched."""
    with open(oracle_out, "rb") as fh:
        want = fh.read()
    res = {}
    for label, consts in FORCED_RESCORES:
        out = os.path.join(WORK, f"parity_rna_{label}")
        os.makedirs(out)
        with _bulk_names(**consts):
            wall, launches = _counted(["cluster", "-i", fq, "-o", out,
                                       "--rna"])
        n_host = _host_rescores()
        check(n_host > 0, f"parity {label}: no host rescore")
        check(launches["lis_filter"] > 0, f"parity {label}: lis_filter "
              f"never ran: {launches}")
        with open(os.path.join(out, "clusters.out"), "rb") as fh:
            check(fh.read() == want, f"parity {label}: clusters.out differs "
                  "from --oracle")
        res[label] = dict(s=wall, launches=launches, host_rescores=n_host)
        print(f"  parity rna {label} ({consts}): byte-identical to --oracle "
              f"({wall:.2f} s, {n_host} host rescores, launches {launches})")
    return res


def phase_parity():
    from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                              synthetic_reads, write_fastq)
    res, hosts = {}, {}
    for label, flags, rc in (("rna", ["--rna"], False),
                             ("cdna", [], True),
                             ("iso", ["--rna", "--iso"], False)):
        reads = synthetic_reads(N_PARITY, N_PARITY * MAIN_FAMILIES //
                                MAIN_READS, seed=7, revcomp=rc)
        fq = os.path.join(WORK, f"parity_{label}.fq")
        write_fastq(reads, fq)
        outs, runs = [], {}
        for engine in ("cuda", "oracle"):
            out = os.path.join(WORK, f"parity_{label}_{engine}")
            os.makedirs(out)
            extra = ["--oracle"] if engine == "oracle" else []
            wall, launches = _counted(["cluster", "-i", fq, "-o", out,
                                       *flags, *extra])
            runs[engine] = dict(s=wall, launches=launches,
                                host_rescores=_host_rescores())
            with open(os.path.join(out, "clusters.out"), "rb") as fh:
                outs.append(fh.read())
        check(all(runs["cuda"]["launches"][k] for k in BLOCK_KERNELS),
              f"parity {label}: a kernel never ran on cuda: {runs['cuda']}")
        check(not any(runs["oracle"]["launches"].values()),
              f"parity {label}: --oracle launched a kernel: {runs['oracle']}")
        check(outs[0] == outs[1], f"parity {label}: clusters.out differs "
              "from --oracle")
        res[label] = runs
        clusters_cuda = os.path.join(WORK, f"parity_{label}_cuda",
                                     "clusters.out")
        hosts[label] = (fq, clusters_cuda,
                        _host_correct(label, fq, clusters_cuda))
        if label == "rna":
            rna_fq = fq
            oracle_out = os.path.join(WORK, "parity_rna_oracle",
                                      "clusters.out")
        print(f"  parity {label}: byte-identical to --oracle (cuda "
              f"{runs['cuda']['s']:.2f} s, launches "
              f"{runs['cuda']['launches']}, "
              f"{runs['cuda']['host_rescores']} host rescores; oracle "
              f"{runs['oracle']['s']:.2f} s)")
    res["forced_rescores"] = _forced_rescores(rna_fq, oracle_out)
    pending = {}
    for label, (fq, clusters_cuda, host) in hosts.items():
        cuda_out, run = _device_correct(label, fq, clusters_cuda)
        pending[label] = (*host, cuda_out, run)
    res["polish"] = _parity_polish(pending["rna"][3])
    _capacity_fallback()
    print(f"phase 7 parity: cluster rna/cDNA and --iso on {N_PARITY} reads "
          "match --oracle byte for byte, and so does cluster --rna with "
          "every borderline pair and every pair over 128 matches rescored "
          "on the host; correct on cuda on all three with no pack on the "
          "host aligner (held to the host path once its runs end, after "
          "phase 8); polish matches the host path byte for byte")
    return res, pending


# phase 8: (label, argv after the mode's input and output, fastq and
# reference directory under WORK, engine constants)
RANK_RUNS = (
    ("rna_8192_shard", ["cluster", "--rna", "--shard-input"], "rna.fq",
     "rna_out", {}),
    ("cdna_8192_shard", ["cluster", "--shard-input"], "cdna.fq", "cdna_out",
     {}),
    ("rna_mesh", ["cluster", "--rna"], "parity_rna.fq", "parity_rna_oracle",
     {}),
    ("rna_shard", ["cluster", "--rna", "--shard-input"], "parity_rna.fq",
     "parity_rna_oracle", {}),
    ("cdna_mesh", ["cluster"], "parity_cdna.fq", "parity_cdna_oracle", {}),
    ("cdna_shard", ["cluster", "--shard-input"], "parity_cdna.fq",
     "parity_cdna_oracle", {}),
    ("iso_mesh", ["cluster", "--rna", "--iso"], "parity_iso.fq",
     "parity_iso_oracle", {}),
    ("rna_shard_all_borderline", ["cluster", "--rna", "--shard-input"],
     "parity_rna.fq", "parity_rna_oracle", dict(VAR_BAND_REL=1e12)),
    ("polish", ["polish", "--rna", "--summary"],
     os.path.join("correct_out", "consensi.fq"), "polish_out", {}),
)
RANKS = 2
RANK_DEADLINE_S = 600


def rank_worker(spec_json: str) -> int:
    """One rank of phase 8: join the process group, run each CLI run of the
    spec with the launch and collective counts set to 0 just before it, and
    print one JSON record (rank, device, and for each run its wall time,
    launches, collective bytes and seconds, host rescores and reads
    fetched from the other rank) as the last line."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.parallel import launch
    from rattle_tpu_torch.pipeline import cli
    from rattle_tpu_torch.utils import metrics
    launch.init_distributed()
    rank = launch.process_index()
    runs = []
    for label, argv, consts in json.loads(spec_json):
        argv = [a.replace("{rank}", str(rank)) for a in argv]
        metrics.GLOBAL.stages.clear()
        metrics.GLOBAL.counters.clear()
        with _bulk_names(**consts):
            torch.cuda.synchronize()
            kernels.reset_launches()
            launch.reset_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c = metrics.GLOBAL.counters
        runs.append(dict(label=label, rc=rc, wall_s=wall,
                         launches=kernels.launches(), **launch.STATS,
                         host_rescores=int(c.get("cluster.host_rescores", 0)),
                         remote_reads=int(c.get("cluster.remote_reads", 0))))
        if rc != 0:
            break
    print(json.dumps(dict(rank=rank, world=launch.process_count(),
                          device=f"cuda:{torch.cuda.current_device()}",
                          runs=runs)))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


def phase_ranks(main_res):
    """Phase 8: the RANK_RUNS through the CLI on two ranks sharing the card,
    each rank in its own output directory; rank 0's files against the
    references, rank 1's directory empty."""
    from rattle_tpu_torch.parallel import launch
    from rattle_tpu_torch.utils.synth import MAIN_READS
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  before the ranks: {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"of device memory free, {torch.cuda.memory_reserved() / 2**30:.2f}"
          " GiB reserved by this process")
    spec, outs = [], {}
    for label, argv, fq, _ref, consts in RANK_RUNS:
        outs[label] = [os.path.join(WORK, f"ranks_{label}_r{r}")
                       for r in range(RANKS)]
        for d in outs[label]:
            os.makedirs(d)
        out = os.path.join(WORK, f"ranks_{label}_r{{rank}}")
        spec.append((label, [argv[0], "-i", os.path.join(WORK, fq), "-o",
                             out, *argv[1:]], consts))
    t0 = time.perf_counter()
    res = launch.run_ranks(
        [sys.executable, os.path.abspath(__file__), "--rank-worker",
         json.dumps(spec)], RANKS, RANK_DEADLINE_S,
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    wall = time.perf_counter() - t0
    recs = []
    for rank, (rc, out, err) in enumerate(res):
        lines = out.strip().splitlines()
        check(rc == 0 and lines, f"phase 8: rank {rank} exited {rc} "
              f"(deadline {RANK_DEADLINE_S} s); stderr tail:\n"
              f"{err[-4000:]}")
        recs.append(json.loads(lines[-1]))
    check([r["rank"] for r in recs] == list(range(RANKS))
          and all(r["world"] == RANKS for r in recs),
          f"phase 8: ranks {[(r['rank'], r['world']) for r in recs]}")
    single = {"rna_8192_shard": main_res["rna"]["cluster_s"],
              "cdna_8192_shard": main_res["cdna"]["cluster_s"]}
    rows = {}
    for i, (label, argv, _fq, ref, consts) in enumerate(RANK_RUNS):
        runs = [r["runs"][i] for r in recs]
        check(all(r["label"] == label for r in runs), f"phase 8: {label}")
        names = ("transcriptome.fq", "polish_summary.tsv") \
            if argv[0] == "polish" else ("clusters.out",)
        _same_files(outs[label][0], os.path.join(WORK, ref), names,
                    f"ranks {label}")
        for d in outs[label][1:]:
            check(os.listdir(d) == [], f"phase 8 {label}: a rank other "
                  f"than 0 wrote {os.listdir(d)}")
        # every rank launches the block's cluster kernels at full size (a
        # sweep's columns may all lie on another rank, so absorb_rest need
        # not run on each); on the small inputs a rank's columns may gate no
        # pair, so there the ranks together must have launched them (and,
        # in polish, each rank aligns every pack)
        need = ("poa_align",) if argv[0] == "polish" else ()
        if label in single:
            need += BLOCK_KERNELS
        for rank, r in enumerate(runs):
            check(all(r["launches"][k] for k in need),
                  f"phase 8 {label}: rank {rank} launched {r['launches']}")
            check(r["calls"] > 0, f"phase 8 {label}: rank {rank} made no "
                  "collective")
        check(all(sum(r["launches"][k] for r in runs)
                  for k in (CLUSTER_KERNELS if label in single
                            else BLOCK_KERNELS)),
              f"phase 8 {label}: a cluster kernel never ran: "
              f"{[r['launches'] for r in runs]}")
        check(not any(r["launches"]["bv_common"] for r in runs),
              f"phase 8 {label}: bv_common launched on the cluster path: "
              f"{[r['launches'] for r in runs]}")
        if consts:
            check(all(r["host_rescores"] > 0 for r in runs),
                  f"phase 8 {label}: no host rescore on a rank")
            check(sum(r["remote_reads"] for r in runs) > 0,
                  f"phase 8 {label}: no rescore needed the other rank's "
                  "read")
        rows[label] = dict(single_s=single.get(label), ranks=runs)
        print(f"  ranks {label}: "
              + "; ".join(f"rank {k} {r['wall_s']:.2f} s, collectives "
                          f"{r['calls']} / {r['bytes_sent']} B sent / "
                          f"{r['bytes_recv']} B received / "
                          f"{r['seconds']:.3f} s, host rescores "
                          f"{r['host_rescores']}, remote reads "
                          f"{r['remote_reads']}, launches {r['launches']}"
                          for k, r in enumerate(runs))
              + (f" (single process, phase 5: {single[label]:.2f} s)"
                 if label in single else ""))
    print(f"phase 8 ranks: {RANKS} ranks on "
          f"{sorted({r['device'] for r in recs})} in {wall:.1f} s; "
          "cluster rna/cDNA (mesh and --shard-input) and --iso on "
          f"{N_PARITY} reads match --oracle, so does --shard-input with "
          "every borderline pair rescored on the host (reads fetched from "
          f"the other rank); --shard-input on {MAIN_READS} reads matches "
          "phase 5 ("
          + ", ".join(f"{lb} {rows[lb]['ranks'][0]['wall_s']:.2f} s against "
                      f"{single[lb]:.2f} s" for lb in single)
          + "); polish matches phase 6; rank 1 wrote nothing")
    return dict(wall_s=wall, device=recs[0]["device"], runs=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2])
    try:
        return run()
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run() -> int:
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.perf_counter()
    smi, build_s = phase_device()
    bv_rows = phase_bv_common(dev)
    kept, cap = _capture_lists(dev)
    gate_rows = phase_gate(dev, cap, bv_rows[0]["bound_ops_per_s"])
    cap.gate, cap.absorb, cap.engine = [], [], None
    lis_rows = phase_lis(dev, kept)
    del kept            # the largest lists of the wave, ~2 GB on the card
    score_rows = phase_score_path(dev, cap)
    poa_rows = phase_poa(dev)
    step_rows = phase_step(dev)
    if "--kernels-only" in sys.argv[1:]:
        print(f"kernel phases only: {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    main_res, fq, clusters_out = phase_main_path()
    correct_res = phase_correct(fq, clusters_out, main_res["rna"]["reads"])
    parity, pending = phase_parity()
    lockstep_res, lockstep_outs = phase_lockstep(
        fq, clusters_out, correct_res["correct_s"],
        os.path.join(WORK, "parity_rna.fq"),
        os.path.join(WORK, "parity_rna_cuda", "clusters.out"))
    ranks = phase_ranks(main_res)
    parity["correct"] = _finish_parity(pending, lockstep_outs)
    step_launches = {k: correct_res["launches"][k]
                     for k in ("poa_align", "poa_thread", "poa_rerank")}
    launches = dict(main_res["rna"]["launches"], **step_launches,
                    poa_align_batch=lockstep_res["launches"][
                        "poa_align_batch"])

    def record(name, row, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    kernels_line = {"kernels": [
        # phase 2's lone calls; on the main path its product runs inside
        # gate_block, so its launches there are 0
        record("bv_common", bv_rows[0], "rattle_tpu_torch/csrc/bv_common.cu",
               "rattle_tpu/ops/pallas_kernels.py:70"),
        record("lis_filter", lis_rows[0],
               "rattle_tpu_torch/csrc/lis_filter.cu",
               "rattle_tpu/ops/pallas_kernels.py:264"),
        # the widest config: full-width reads of up to 4,094 bases
        record("poa_align", poa_rows[-1],
               "rattle_tpu_torch/csrc/poa_align.cu",
               "rattle_tpu/ops/poa_pallas.py:556"),
        # the score path (the parts of JAX's jitted score and replay
        # programs); the join and decision rows are the first wave's
        # largest launch at W = 2048, M = 128 (the narrowest class of the
        # count pass), the replay row its block
        record("join_expand", score_rows["join_expand"][0],
               "rattle_tpu_torch/csrc/join_expand.cu",
               "rattle_tpu/cluster/bulk.py:245"),
        record("score_decide", score_rows["score_decide"][0],
               "rattle_tpu_torch/csrc/score_decide.cu",
               "rattle_tpu/cluster/bulk.py:276"),
        record("greedy_owner", score_rows["greedy_owner"][0],
               "rattle_tpu_torch/csrc/greedy_owner.cu",
               "rattle_tpu/cluster/bulk.py:459"),
        # the rest of the wave's programs (JAX's jitted gate_class_block
        # and absorb_rest): the first wave's block, the first sweep tile
        record("gate_block", gate_rows["gate_block"][0],
               "rattle_tpu_torch/csrc/gate_block.cu",
               "rattle_tpu/cluster/bulk.py:146"),
        record("absorb_rest", gate_rows["absorb_rest"][0],
               "rattle_tpu_torch/csrc/absorb_rest.cu",
               "rattle_tpu/cluster/bulk.py:483"),
        # the read step after the alignment (the rest of JAX's jitted
        # _step), at the widest config's 64 lanes
        record("poa_thread", step_rows[4096][0],
               "rattle_tpu_torch/csrc/poa_thread.cu",
               "rattle_tpu/correct/pack_engine.py:168"),
        record("poa_rerank", step_rows[4096][1],
               "rattle_tpu_torch/csrc/poa_rerank.cu",
               "rattle_tpu/correct/pack_engine.py:266"),
        # the lockstep runner's alignment (JAX's jitted poa_align_batch),
        # the lockstep correct run's largest int32 step
        record("poa_align_batch", lockstep_res["kernel_rows"][4096],
               "rattle_tpu_torch/csrc/poa_align_batch.cu",
               "rattle_tpu/ops/poa_device.py:49"),
    ]}
    report = dict(card=smi, build_s=build_s, bv_common=bv_rows,
                  gate=gate_rows, lis_filter=lis_rows, score_path=score_rows,
                  poa_align=poa_rows,
                  step_kernels={str(w): r for w, r in step_rows.items()},
                  main_path=main_res, correct_path=correct_res,
                  lockstep=lockstep_res, parity=parity, ranks=ranks,
                  total_s=time.perf_counter() - t_start, **kernels_line)
    with open(os.path.join(WORK, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"total {report['total_s']:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
