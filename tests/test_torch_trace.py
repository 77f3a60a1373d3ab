"""The program's spans and counters (``utils.metrics.GLOBAL``) over whole
``cluster`` jobs on the CPU, above the engine's oracle cutover: every span
adds time, the spans nest and fit the job's wall, they are the profiler's
ranges while a profiler records and make no profiler call otherwise, and
the join's pair counters agree with the gate's and the tiers' counts."""

import time

import pytest
import torch

from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.pipeline import cli
from rattle_tpu_torch.pipeline.profile_cluster import idle_by_span
from rattle_tpu_torch.utils import metrics
from rattle_tpu_torch.utils.synth import synthetic_reads, write_fastq

torch.set_num_threads(1)

READS = 256
# the spans a job adds beside the engine's phases and wave sections
NEW = ("cluster.parse", "cluster.setup", "cluster.wave", "cluster.fetch",
       "cluster.write")
PHASES = ("cluster.greedy", "cluster.merge")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """{"rna", "cdna"}: READS synthetic reads of 300-600 bases over 24
    genes (cDNA: half reverse-complemented)."""
    assert READS > bulk.ORACLE_CUTOVER
    d = tmp_path_factory.mktemp("trace")
    out = {}
    for kind in ("rna", "cdna"):
        path = str(d / f"{kind}.fq")
        write_fastq(synthetic_reads(READS, 24, 17, revcomp=kind == "cdna",
                                    lo=300, hi=600), path)
        out[kind] = path
    return out


def _job(fq: str, out, kind: str = "rna"):
    """One ``cluster`` job through the CLI on the CPU: its wall seconds and
    the stages and counters it added to GLOBAL."""
    st0, c0 = dict(metrics.GLOBAL.stages), dict(metrics.GLOBAL.counters)
    flags = ["--rna"] if kind == "rna" else []
    t0 = time.perf_counter()
    assert cli.main(["cluster", "-i", fq, "-o", str(out), "--device", "cpu",
                     *flags]) == 0
    wall = time.perf_counter() - t0
    st = {k: v - st0.get(k, 0.0) for k, v in metrics.GLOBAL.stages.items()
          if v != st0.get(k)}
    cnt = {k: v - c0.get(k, 0.0) for k, v in metrics.GLOBAL.counters.items()}
    return wall, st, cnt


def test_job_spans_nest_and_fit_the_wall(reads, tmp_path):
    wall, st, _ = _job(reads["rna"], tmp_path)
    for name in NEW + PHASES:
        assert st.get(name, 0.0) > 0, name
    assert st["cluster.fetch"] <= st["cluster.wave"] \
        <= st["cluster.greedy"] + st["cluster.merge"]
    assert sum(st[k] for k in ("cluster.parse", "cluster.setup",
                               "cluster.write") + PHASES) <= wall
    # on the CPU no section has a device time
    assert not any(k.endswith("_dev") for k in st)


def test_spans_are_profiler_ranges_inside_the_job(reads, tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("test/job"):
            _wall, st, _ = _job(reads["rna"], tmp_path)
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith(("cluster.", "test/"))]
    job = [(a, b) for n, a, b in ev if n == "test/job"]
    assert len(job) == 1
    ranges = [r for r in ev if r[0].startswith("cluster.")]
    assert {n for n, _a, _b in ranges} >= set(NEW + PHASES)
    assert all(job[0][0] <= a <= b <= job[0][1] for _n, a, b in ranges)
    waves = [(a, b) for n, a, b in ranges if n == "cluster.wave"]
    for _n, a, b in (r for r in ranges if r[0] == "cluster.fetch"):
        assert any(wa <= a and b <= wb for wa, wb in waves)
    for name in {n for n, _a, _b in ranges}:
        got = sum(b - a for n, a, b in ranges if n == name) / 1e6
        assert got == pytest.approx(st[name], rel=0.1, abs=1e-3), name


def test_spans_make_no_profiler_call_without_a_profiler(reads, tmp_path,
                                                         monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _wall, st, _ = _job(reads["rna"], tmp_path)
    assert all(st.get(name, 0.0) > 0 for name in NEW)


@pytest.mark.parametrize("case", ["rna", "cdna", "overflow"])
def test_pair_counters_match_the_gate_and_the_tiers(reads, tmp_path,
                                                    monkeypatch, case):
    """Every gated pair is joined at the first M tier, so the first tier's
    ``cluster.pairs.*`` sum to ``cluster.gate_pairs``; the later tiers' sum
    to the pairs tier_partition routes there, and ``overflow_pairs`` to
    those past the last tier (forced in "overflow": one tier of 128)."""
    seen = []
    real = bulk.tier_partition

    def spy(*a, **k):
        order, counts = real(*a, **k)
        seen.append(counts.clone())
        return order, counts
    monkeypatch.setattr(bulk, "tier_partition", spy)
    if case == "overflow":
        monkeypatch.setattr(bulk, "M_LADDER", (128,))
    _wall, _st, cnt = _job(reads["cdna" if case == "cdna" else "rna"],
                           tmp_path, "cdna" if case == "cdna" else "rna")
    gated = sum(int(c.sum()) for c in seen)
    later = sum(int(c[:, 1:-1].sum()) for c in seen)
    over = sum(int(c[:, -1].sum()) for c in seen)
    pairs = {k: v for k, v in cnt.items() if k.startswith("cluster.pairs.")}
    m0 = min(int(k.rsplit(".m", 1)[1]) for k in pairs)
    first = sum(v for k, v in pairs.items() if k.endswith(f".m{m0}"))
    assert gated > 0
    assert cnt["cluster.gate_pairs"] == gated
    assert first == gated
    assert sum(pairs.values()) - first == later
    assert cnt.get("cluster.overflow_pairs", 0) == over
    assert (over > 0) if case == "overflow" else (later > 0)


def test_idle_gaps_split_by_the_innermost_open_range():
    """profile_cluster's split of the device's idle time: each instant of a
    gap goes to the innermost program range open then, or to no span."""
    busy = [[1.0, 2.0], [3.0, 3.5], [9.0, 12.0]]
    ranges = [("cluster.greedy", 0.5, 8.0), ("cluster.wave", 2.5, 4.0),
              ("cluster.fetch", 3.2, 3.8), ("cluster.write", 5.0, 5.0)]
    got = idle_by_span((0.0, 10.0), busy, ranges)
    assert got == pytest.approx({"cluster.greedy": 5.0, "(no span)": 1.5,
                                 "cluster.wave": 0.7, "cluster.fetch": 0.3})
    assert sum(got.values()) == pytest.approx(10.0 - 1.0 - 0.5 - 1.0)
