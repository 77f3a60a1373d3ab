"""The lockstep runner (RATTLE_POA_BACKEND=lockstep) against the pack
engine on the card, at full size, and the helpers chip_smoke.py's phase 6c
shares with it.

    python -m rattle_tpu_torch.pipeline.profile_lockstep

Clusters chip_smoke.py's main-path input (utils/synth.py MAIN_READS,
MAIN_FAMILIES, MAIN_SEED) through the CLI on cuda and runs ``correct`` on
every cluster twice in one process: on the pack engine, then with
RATTLE_POA_BACKEND=lockstep; the two runs' files must be the same bytes.
Then ``poa_align_batch`` on the lockstep run's largest read step at W =
1024, 2048 and 4096, with four lanes added (``extra_lanes``): exact against
its plain version with int16 and int32 predecessors, timed (CUDA events,
the median of five lone calls; the plain version one call).  Prints the
lockstep runner's read steps, aligning, host and host-aligner seconds and
packs beside the pack engine's wall and statistics; the last line is one
JSON object with these numbers.  chip_smoke.py's phase 6c runs the
lockstep path on a cut of the clusters; this script measures it whole (~4
minutes on an H100).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline.profile_correct import _run
from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                          MAIN_SEED, synthetic_reads,
                                          write_fastq)

# the step widths (l_cap) the kernel is held to its plain version at:
# int16 cells at 1024 and 2048, int32 at 4096
WIDTHS = (1024, 2048, 4096)
CORRECT_FILES = ("corrected.fq", "uncorrected.fq", "consensi.fq")


@contextlib.contextmanager
def backend(name: str):
    """RATTLE_POA_BACKEND set to ``name`` for the duration of the block."""
    old = os.environ.get(runner.BACKEND_ENV)
    os.environ[runner.BACKEND_ENV] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ[runner.BACKEND_ENV]
        else:
            os.environ[runner.BACKEND_ENV] = old


def batch_cells(args) -> torch.Tensor:
    """DP cells of each lane of a poa_align_batch call: n_nodes x
    (seq_len + 1)."""
    n_nodes, seq_len = args[2], args[4]
    return n_nodes.to(torch.int64) * (seq_len.to(torch.int64) + 1)


@contextlib.contextmanager
def capture():
    """Hooks on correct/runner.py for lockstep runs: every LockstepRunner
    made (for its stats), and, for each step width, the inputs of the read
    step with the most DP cells (cloned)."""
    made, steps = [], {}
    real_make, real_align = runner.LockstepRunner, runner.poa_align_batch

    def make(*a, **kw):
        made.append(real_make(*a, **kw))
        return made[-1]

    def align(*args, **kw):
        width = args[3].shape[1]
        cells = int(batch_cells(args).sum())
        if cells > steps.get(width, (0,))[0]:
            steps[width] = (cells, [x.clone() for x in args[:5]])
        return real_align(*args, **kw)

    runner.LockstepRunner, runner.poa_align_batch = make, align
    try:
        yield made, steps
    finally:
        runner.LockstepRunner, runner.poa_align_batch = real_make, real_align


def extra_lanes(args, dev, seed: int):
    """A captured lockstep step with four more lanes: an empty graph with a
    read, lane 0's graph with an unrelated read, lane 0's graph with a read
    that runs past the end of its graph (lane 0's read, then its start
    again, cut to the width), and a lane staged as the runner stages a pack
    past its last read (no graph, no read).  Returns (inputs, {case: lane
    index})."""
    letters, preds, n_nodes, seq, seq_len = [x.clone() for x in args]
    w = seq.shape[1]
    e, u, p, z = (letters.shape[0] + i for i in range(4))
    letters, preds, n_nodes, seq, seq_len = (
        torch.cat([x, x[:1].repeat((4,) + (1,) * (x.dim() - 1))])
        for x in (letters, preds, n_nodes, seq, seq_len))
    g = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    n_nodes[e] = 0
    n0 = int(seq_len[0])
    seq[u, :n0] = bases[torch.randint(0, 4, (n0,), generator=g, device=dev)]
    longer = min(2 * n0, w - 1)
    seq[p, n0:longer] = seq[0, :longer - n0]
    seq_len[p] = longer
    letters[z], preds[z], n_nodes[z], seq[z], seq_len[z] = 0, -1, 0, 0, 0
    return [letters, preds, n_nodes, seq, seq_len], dict(
        empty=e, unrelated=u, past_graph=p, past_last_read=z)


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def kernel_row(args, extra: dict) -> dict:
    """poa_align_batch on a step's inputs (``extra_lanes``) against its
    plain version, exactly (length, aligned and the moves below length),
    with its predecessors as the runner gives them (int16) and as int32;
    the empty and idle lanes emit no move, the unrelated and past-the-graph
    lanes align.  Then timed: ``ms`` the median of five lone calls,
    ``plain_ms`` one call of the plain version."""
    b, n = args[0].shape
    w = args[3].shape[1]
    scratch = torch.empty(kernels.poa_batch_scratch_bytes(b, n, w),
                          dtype=torch.uint8, device=args[0].device)
    got = kernels.poa_align_batch(*args, scratch=scratch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = kernels.poa_align_batch_plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    lens = ref[1].tolist()
    got32 = kernels.poa_align_batch(args[0], args[1].to(torch.int32),
                                    *args[2:], scratch=scratch)
    for what, res in (("int16", got), ("int32", got32)):
        bad = [li for li, ln in enumerate(lens)
               if not torch.equal(res[0][li, :ln], ref[0][li, :ln])]
        _check(not bad and torch.equal(res[1], ref[1])
               and torch.equal(res[2], ref[2]),
               f"poa_align_batch W={w} ({what} preds): lanes {bad} differ, "
               f"lengths {res[1].tolist()} against {lens}")
    aligned = ref[2].tolist()
    _check(all(lens[x] == 0 and not aligned[x]
               for x in (extra["empty"], extra["past_last_read"])),
           f"poa_align_batch W={w}: an empty or idle lane produced moves")
    _check(aligned[extra["unrelated"]] and aligned[extra["past_graph"]],
           f"poa_align_batch W={w}: an added lane did not align")
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.poa_align_batch(*args, scratch=scratch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times[1:])
    ranks = args[2].tolist()
    return dict(shape=[b, n, w], ranks=ranks, read_len=args[4].tolist(),
                moves=lens, cells=int(batch_cells(args).sum()),
                pred_dtype=str(args[1].dtype), ms=ms, plain_ms=plain_ms,
                us_per_rank=ms * 1e3 / max(max(ranks), 1), max_abs_err=0)


def kernel_rows(dev, steps) -> dict:
    """``kernel_row`` on the captured step of each of WIDTHS, with the
    added lanes."""
    _check(set(WIDTHS) <= set(steps),
           f"lockstep: no step captured at some width: {sorted(steps)}")
    rows = {}
    for w in WIDTHS:
        args, extra = extra_lanes(steps[w][1], dev, seed=w)
        rows[w] = kernel_row(args, extra)
    return rows


def same_files(a: str, b: str, what: str) -> None:
    """The three ``correct`` outputs of directories ``a`` and ``b`` are
    the same bytes."""
    for name in CORRECT_FILES:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            _check(fa.read() == fb.read(), f"{what}: {name} differs")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lockstep needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # every kernel built before the timed runs (nvcc takes seconds a kernel)
    _ext.build(_ext.KERNELS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED), fq)
        _run(["cluster", "-i", fq, "-o", tmp, "--rna"])
        outs = {k: os.path.join(tmp, k) for k in ("engine", "lockstep")}
        for d in outs.values():
            os.makedirs(d)
        correct = ["correct", "-i", fq, "-c",
                   os.path.join(tmp, "clusters.out"), "-o"]
        engine_s = _run(correct + [outs["engine"]])
        engine = dict(runner.LAST_STATS)
        before = kernels.poa_align_batch.launches
        with backend("lockstep"), capture() as (made, steps):
            lockstep_s = _run(correct + [outs["lockstep"]])
        launches = kernels.poa_align_batch.launches - before
        same_files(outs["lockstep"], outs["engine"],
                   "lockstep against the pack engine")
    ls = made[0].stats
    _check(launches == ls["steps"],
           f"{launches} launches for {ls['steps']} steps")
    rows = kernel_rows(dev, steps)
    for w, r in rows.items():
        print(f"poa_align_batch W={w} lanes={r['shape'][0]} "
              f"N={r['shape'][1]}: exact; ranks {r['ranks']}, {r['ms']:.3f} "
              f"ms ({r['us_per_rank']:.2f} us a rank), plain "
              f"{r['plain_ms']:.1f} ms", file=sys.stderr)
    steps_n = max(ls["steps"], 1)
    print(f"{card}: {MAIN_READS} reads, correct on every cluster: pack "
          f"engine {engine_s:.2f} s ({engine['steps']} steps, t_steps_s "
          f"{engine.get('t_steps_s')}); lockstep {lockstep_s:.2f} s "
          f"({ls['steps']} read steps: aligning {ls['t_align_s']:.2f} s, "
          f"{1e3 * ls['t_align_s'] / steps_n:.2f} ms a step; host "
          f"{ls['t_host_s']:.2f} s, {1e3 * ls['t_host_s'] / steps_n:.2f} ms "
          f"a step; host aligner {ls['t_fallback_s']:.2f} s; device "
          f"{ls['device_packs']} packs / {ls['device_bases']} bases, host "
          f"{ls['fallback_packs']} packs / {ls['host_bases']} bases); files "
          "byte-identical", file=sys.stderr)
    print(json.dumps(dict(card=card, reads=MAIN_READS, engine_s=engine_s,
                          engine=engine, lockstep_s=lockstep_s,
                          lockstep=ls, launches=launches,
                          kernel_rows={str(w): r for w, r in rows.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
