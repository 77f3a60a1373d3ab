"""Drive the PyTorch/CUDA port (rattle_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each ending in one summary line:
  1. device and build: the card's name and power limit; both CUDA kernels
     compiled with nvcc from rattle_tpu_torch/csrc (all at once);
  2. bv_common against its plain version, exactly, at the main path's
     shapes, with CUDA-event times and the bf16 matmul yardstick;
  3. lis_filter against its plain version at M in {128, 512, 2048};
  4. the main path: ``cluster --rna`` on 8,192 synthetic reads through the
     port's CLI on cuda, then ``cluster_summary`` and ``extract_clusters``;
     then ``cluster`` in cDNA mode (both strands) on 8,192 reads; in each
     run every read must land in one cluster and both kernels must have run;
  5. parity: ``cluster`` (rna, cDNA) and ``cluster --iso`` on 256 reads of
     the same generator must write the same clusters.out as ``--oracle``,
     with both kernels launched in the cuda run and none in the oracle's.

Launch counts are set to 0 just before each ``cluster`` run and read just
after it; the kernels line reports those of the ``--rna`` main path.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense int8 ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12

N_PARITY = 256


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
    report = _ext.build(_ext.KERNELS)
    build_s = time.perf_counter() - t0
    for name in _ext.KERNELS:
        _ext.load(name)
    for name, (secs, log) in report.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  build {name}: {secs:.2f} s; {' | '.join(regs)}")
    print(f"phase 1 device+build: {smi[0]}; kernels built in {build_s:.2f} s "
          f"(compiled now: {sorted(report)})")
    return smi[0], build_s


def _random_words(p: int, density: float, dev, seed: int) -> torch.Tensor:
    from rattle_tpu_torch.ops.sketch_device import pack_bits
    g = torch.Generator(device=dev).manual_seed(seed)
    plane = torch.rand((p, 4096), generator=g, device=dev) < density
    return pack_bits(plane.to(torch.uint8))


def phase_bv_common(dev):
    from rattle_tpu_torch.ops import kernels
    rows = []
    # a block wave, a sweep tile, and a ragged shape with zero rows; bit
    # densities of 1,000-3,000 bp reads (~25-50% of the 4,096 6-mers)
    for p, s in ((4096, 4096), (1024, 8192), (1000, 777)):
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
            continue
        ms = time_ms(lambda: kernels.bv_common(pool, seed))
        plain_ms = time_ms(lambda: kernels.bv_common_plain(pool, seed), 5)
        a = kernels.unpack_bits(pool).to(torch.bfloat16)
        b = kernels.unpack_bits(seed).to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.matmul(a, b.T))
        nbytes = (p + s) * 512 + p * s * 4
        ops = 2 * p * s * 4096
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_INT8) * 1e3
        row = dict(shape=[p, s], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound,
                   bound_by="bytes" if nbytes / PEAK_BYTES > ops / PEAK_INT8
                   else "operations", max_abs_err=err)
        rows.append(row)
        print(f"  bv_common [{p}x128]x[{s}x128]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({row['bound_by']})")
    print("phase 2 bv_common: exact against the plain version at "
          "[4096x4096], [1024x8192], ragged [1000x777]")
    return rows


def _match_lists(b: int, m: int, dev, seed: int):
    """Join-shaped lists: counts spread up to m, mostly colinear matches
    (a long LIS with gaps, as real read pairs give), sorted by (p1, p2)."""
    g = np.random.default_rng(seed)
    n_valid = g.integers(m // 4, m + 1, size=b)
    p1 = np.sort(g.integers(0, 8 * m, (b, m)), axis=1)
    p2 = np.where(g.random((b, m)) < 0.8, p1 + g.integers(-6, 7, (b, m)),
                  g.integers(0, 8 * m, (b, m)))
    order = np.lexsort((p2, p1), axis=1)
    p1 = np.take_along_axis(p1, order, axis=1)
    p2 = np.take_along_axis(p2, order, axis=1)
    valid = np.arange(m)[None, :] < n_valid[:, None]
    p1 = np.where(valid, p1, 0).astype(np.int32)
    p2 = np.where(valid, p2, 2**31 - 1).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (p1, p2, valid)]
    bound = torch.tensor([int(n_valid.max())], dtype=torch.int32, device=dev)
    return t, bound


def phase_lis(dev):
    from rattle_tpu_torch.cluster.bulk import SCORE_CHUNKS
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.ops.lis_select import lis_build_select
    rows = []
    for tier, m in enumerate((128, 512, 2048)):
        b = SCORE_CHUNKS[0][tier]
        (p1, p2, valid), bound = _match_lists(b, m, dev, seed=m)
        got = kernels.lis_filter(p1, p2, valid, 10, 10, bound)
        ref = kernels.lis_filter_plain(p1, p2, valid, 10, 10, bound)
        torch.cuda.synchronize()
        for name, g_, r_ in zip(("bases", "hc", "n_dist"), got, ref):
            check(torch.equal(g_, r_), f"lis_filter M={m}: {name} differs")
        finite = torch.isfinite(ref[3])
        check(torch.equal(torch.isfinite(got[3]), finite),
              f"lis_filter M={m}: var inf pattern differs")
        check(torch.allclose(got[3][finite], ref[3][finite], rtol=1e-5,
                             atol=1e-5), f"lis_filter M={m}: var off")
        err = float((got[3][finite] - ref[3][finite]).abs().max())
        ms = time_ms(lambda: kernels.lis_filter(p1, p2, valid, 10, 10, bound))
        plain_ms = time_ms(lambda: kernels.lis_filter_plain(
            p1, p2, valid, 10, 10, bound), reps=2 if m == 2048 else 3,
            warmup=1)
        # bytes the function must move on these lists: valid up to the bound
        # (1 byte a slot), p2 at the valid slots and p1 at the LIS anchors
        # (4 bytes each), the bound itself and four [B] outputs
        nb = int(bound)
        lis_len = lis_build_select(p2[:, :nb], valid[:, :nb])[2]
        nbytes = (b * nb + 4 * int(valid[:, :nb].sum())
                  + 4 * int(lis_len.sum()) + 4 + 16 * b)
        row = dict(shape=[b, m], bound=nb, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=nbytes / PEAK_BYTES * 1e3,
                   bound_by="bytes", max_abs_err=err)
        rows.append(row)
        print(f"  lis_filter B={b} M={m} bound={int(bound)}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
              f"{row['bound_ms']:.5f} ms (bytes), var max abs err {err:.3g}")
    print("phase 3 lis_filter: bases/hc/n_dist exact, var within rtol 1e-5, "
          "at M = 128, 512, 2048")
    return rows


def _cli(argv, capture: bool = False):
    from rattle_tpu_torch.pipeline import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf if capture else sys.stderr):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return buf.getvalue()


def _cluster_counted(argv):
    """Run ``cluster`` with both launch counts set to 0 just before it and
    the run's metrics cleared; returns (wall seconds, this run's launches)."""
    from rattle_tpu_torch.ops import kernels
    from rattle_tpu_torch.utils import metrics
    metrics.GLOBAL.stages.clear()
    metrics.GLOBAL.counters.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _cli(["cluster", *argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, kernels.launches()


def _host_rescores() -> int:
    from rattle_tpu_torch.utils import metrics
    return int(metrics.GLOBAL.counters.get("cluster.host_rescores", 0))


def _main_run(label, reads, flags):
    """Cluster ``reads`` on cuda; every read must land in one cluster and
    both kernels must have launched in this run."""
    from rattle_tpu_torch.io import hpsio
    from rattle_tpu_torch.utils import metrics
    from rattle_tpu_torch.utils.synth import write_fastq
    fq = os.path.join(WORK, f"{label}.fq")
    out = os.path.join(WORK, f"{label}_out")
    os.makedirs(out)
    write_fastq(reads, fq)
    torch.cuda.reset_peak_memory_stats()
    wall, launches = _cluster_counted(["-i", fq, "-o", out, *flags])
    check(all(launches.values()), f"{label}: a kernel never ran: {launches}")
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
                           if k[8:] in ("gate", "score", "rescore", "replay")},
               host_rescores=_host_rescores(), launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  {label} ({' '.join(flags) or 'cDNA'}): {len(clusters)} clusters,"
          f" purity {res['purity']:.4f}; cluster {wall:.2f} s "
          f"({res['reads_per_s']:.1f} reads/s: greedy {res['greedy_s']:.2f} s,"
          f" merge {res['merge_s']:.2f} s; sections "
          f"{ {k: round(v, 3) for k, v in res['sections_s'].items()} }), "
          f"{res['host_rescores']} host rescores, peak "
          f"{res['peak_mem_gib']:.2f} GiB, launches {launches}")
    return res, fq, os.path.join(out, "clusters.out")


def phase_main_path():
    """``cluster --rna`` (the main path, then ``cluster_summary`` and
    ``extract_clusters`` on its output) and ``cluster`` in cDNA mode (both
    strands), each on 8,192 reads with its own launch counts."""
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
    cdna = _main_run("cdna", synthetic_reads(MAIN_READS, MAIN_FAMILIES,
                                             MAIN_SEED, revcomp=True), [])[0]
    print(f"phase 4 main path: cluster --rna and cDNA cluster on {MAIN_READS} "
          f"reads of {MAIN_FAMILIES} families on cuda, every read in one "
          "cluster, both kernels launched in each run")
    return dict(rna=rna, cdna=cdna)


def phase_parity():
    from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                              synthetic_reads, write_fastq)
    res = {}
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
            wall, launches = _cluster_counted(["-i", fq, "-o", out, *flags,
                                               *extra])
            runs[engine] = dict(s=wall, launches=launches,
                                host_rescores=_host_rescores())
            with open(os.path.join(out, "clusters.out"), "rb") as fh:
                outs.append(fh.read())
        check(all(runs["cuda"]["launches"].values()),
              f"parity {label}: a kernel never ran on cuda: {runs['cuda']}")
        check(not any(runs["oracle"]["launches"].values()),
              f"parity {label}: --oracle launched a kernel: {runs['oracle']}")
        check(outs[0] == outs[1], f"parity {label}: clusters.out differs "
              "from --oracle")
        res[label] = runs
        print(f"  parity {label}: byte-identical to --oracle (cuda "
              f"{runs['cuda']['s']:.2f} s, launches "
              f"{runs['cuda']['launches']}, "
              f"{runs['cuda']['host_rescores']} host rescores; oracle "
              f"{runs['oracle']['s']:.2f} s)")
    print(f"phase 5 parity: cluster rna/cDNA and --iso on {N_PARITY} reads "
          "match --oracle byte for byte")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.perf_counter()
    smi, build_s = phase_device()
    bv_rows = phase_bv_common(dev)
    lis_rows = phase_lis(dev)
    main_res = phase_main_path()
    parity = phase_parity()

    def record(name, row, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": main_res["rna"]["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    kernels_line = {"kernels": [
        record("bv_common", bv_rows[0], "rattle_tpu_torch/csrc/bv_common.cu",
               "rattle_tpu/ops/pallas_kernels.py:70"),
        record("lis_filter", lis_rows[0],
               "rattle_tpu_torch/csrc/lis_filter.cu",
               "rattle_tpu/ops/pallas_kernels.py:264"),
    ]}
    report = dict(card=smi, build_s=build_s, bv_common=bv_rows,
                  lis_filter=lis_rows, main_path=main_res, parity=parity,
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
