"""The correct mode on the CPU at sizes a test run holds: the plain POA
against the port's POA spec, the reference's trimming and correction rules
against hand-made MSAs, the sample, whole runs of the harness (correct as
the program is, not correct with its path broken or with the control in its
place), and the readers of the mode's metrics.

On the CPU the pack engine's plain kernels take most of a minute a job, so
the whole runs take the program's host aligner (RATTLE_POA_BACKEND=native),
which writes the same files; the pack engine runs on the card."""

import os
import tempfile
import time

import numpy as np
import pytest

from gpubench import control, harness, synth
from gpubench.modes import correct as mode
from gpubench.reference import correct as ref

from .conftest import small
from .test_gpubench_imports import imported

# 20 packs of 2-60 reads of 50-1,500 bp: (reads, transcript length)
PACKS = [(2, 1500), (3, 1200), (4, 900), (5, 1500), (6, 700), (8, 1100),
         (10, 600), (12, 800), (14, 400), (16, 500), (20, 300), (24, 350),
         (28, 250), (32, 200), (36, 150), (40, 120), (45, 100), (50, 80),
         (55, 60), (60, 50)]


def _pack(i, n, length):
    """n noisy copies of one transcript, some cut short, one with a foreign
    prefix and, in every fourth pack, one foreign read."""
    rng = np.random.default_rng([7, i])
    tx = rng.choice(synth._BASES, length)
    seqs = []
    for j in range(n):
        s = synth.mutate(rng, tx, 0.08)
        if j % 5 == 3:
            s = s[len(s) // 5:len(s) - len(s) // 6]
        if j == 1:
            s = np.concatenate([rng.choice(synth._BASES, 30), s])
        seqs.append(s.tobytes())
    if i % 4 == 0:
        seqs[-1] = rng.choice(synth._BASES, max(20, length // 3)).tobytes()
    return seqs


@pytest.mark.parametrize("i", range(len(PACKS)))
def test_poa_ref_is_the_ports_poa(i):
    from rattle_tpu_torch.ops import poa
    seqs = _pack(i, *PACKS[i])
    want = poa.poa_msa([s.decode() for s in seqs])
    assert [bytes(r).decode() for r in ref.msa(seqs)] == want


def test_the_control_changes_co_optimal_choices():
    """E before F in the traceback changes some pack's MSA."""
    differ = [ref.msa(_pack(i, *PACKS[i])) != ref.msa(_pack(i, *PACKS[i]),
                                                      True)
              for i in range(0, len(PACKS), 2)]
    assert any(differ)


def _rows(rng, n, w):
    """Hand-made MSA rows: blocks of bases between gap runs of 1-40, so that
    small blocks before long gaps sit at both ends."""
    rows = []
    for _ in range(n):
        row = bytearray(b"-" * w)
        at = int(rng.integers(0, w // 4))
        while at < w:
            size = int(rng.choice([1, 3, 9, 10, 30]))
            row[at:at + size] = rng.choice(synth._BASES, min(size, w - at)
                                           ).tobytes()
            at += size + int(rng.choice([1, 3, 4, 19, 20, 40]))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_trim_and_correction_are_the_ports_rules(seed):
    """fix_msa_ends, the consensus and the correction against the port's
    versions of RATTLE's rules, on MSAs with small blocks at the ends and
    qualities that put the consensus's mean error on a rounding edge."""
    from rattle_tpu_torch.correct import consensus as port
    from rattle_tpu_torch.io.fastx import Read
    rng = np.random.default_rng(seed)
    rows = _rows(rng, 40, 300)
    quals = [bytes(rng.choice([40, 41, 73], int(np.sum(np.frombuffer(r,
             np.uint8) != ord("-")))).astype(np.uint8)) for r in rows]
    recs = [ref.Record(f"@r{i}", bytes(r).replace(b"-", b""), q)
            for i, (r, q) in enumerate(zip(rows, quals))]
    reads = [Read(r.header, r.seq.decode(), "+", r.qual.decode())
             for r in recs]
    aln = [bytes(r).decode() for r in rows]
    ref.fix_msa_ends(rows, recs)
    port.fix_msa_ends(reads, aln)
    assert [bytes(r).decode() for r in rows] == aln
    assert [(r.seq.decode(), r.qual.decode()) for r in recs] == \
        [(r.seq, r.quality) for r in reads]
    p = dict(gap_occ=0.3, min_occ=0.3, err_ratio=ref.ERR_RATIO,
             float=np.float64)
    cor, unc = ref.correct_pack(rows, recs, p)
    pcor, punc, cv = port.correct_read_pack(reads, aln, 0.3, 0.3, 30.0)
    assert [(r.header, r.seq.decode(), r.qual.decode()) for r in cor] == \
        [(r.header, r.seq, r.quality) for r in pcor]
    assert [r.header for r in unc] == [r.header for r in punc]
    assert ref.Columns(rows, recs).consensus().decode() == \
        cv.consensus_string()


def test_float32_changes_a_quality_on_a_rounding_edge():
    """Where a column's mean error lands on the edge of a quality letter
    (qualities 32, 32, 4 and 32 agreeing), float32 arithmetic gives another
    letter to the base it replaces than RATTLE's float64, and the port
    gives float64's."""
    from rattle_tpu_torch.correct import consensus as port
    from rattle_tpu_torch.io.fastx import Read
    rows = [bytearray(b"A" * 12) for _ in range(5)]
    rows[4][6] = ord("C")
    quals = [bytearray(b"5" * 12) for _ in range(5)]
    for i, q in enumerate((32, 32, 4, 32, 10)):
        quals[i][6] = q + 33
    p = dict(gap_occ=0.3, min_occ=0.3, err_ratio=ref.ERR_RATIO)
    letters = []
    for ft in (np.float64, np.float32):
        recs = [ref.Record(f"@r{i}", bytes(r), bytes(q))
                for i, (r, q) in enumerate(zip(rows, quals))]
        cor, _unc = ref.correct_pack(rows, recs, dict(p, float=ft))
        assert cor[4].seq == b"A" * 12
        letters.append(cor[4].qual[6])
    assert letters == [42, 43]
    reads = [Read(f"@r{i}", bytes(r).decode(), "+", bytes(q).decode())
             for i, (r, q) in enumerate(zip(rows, quals))]
    pcor, _punc, _cv = port.correct_read_pack(
        reads, [bytes(r).decode() for r in rows], 0.3, 0.3, 30.0)
    assert pcor[4].quality[6] == chr(42)


def _cell_data():
    cfg = harness.load_json(os.path.join(harness.ROOT, "gpubench", "configs",
                                         "rna_toyset.json"))
    mix = harness.load_json(os.path.join(harness.ROOT, "gpubench", "traffic",
                                         "correct.zipf.json"))
    return dict(cfg["data"], **mix["data"])


def test_sample_holds_its_clusters_and_share():
    data = _cell_data()
    sizes = mode.cluster_sizes(data).tolist()
    n = len(sizes)
    lengths = synth.gene_sizes(1, n, 0.0, 300, 3000)[1]
    longest = [int(x) + 40 for x in lengths]
    bases = [s * int(x) for s, x in zip(sizes, lengths)]
    a = mode.choose_sample(sizes, longest, bases, 2 ** 31 + 5, 0, 0.15, 5)
    assert a == mode.choose_sample(sizes, longest, bases, 2 ** 31 + 5, 0,
                                   0.15, 5)
    assert a != mode.choose_sample(sizes, longest, bases, 2 ** 31 + 6, 0,
                                   0.15, 5)
    assert a != mode.choose_sample(sizes, longest, bases, 2 ** 31 + 5, 1,
                                   0.15, 5)
    for seed in (1, 2, 3, -4):
        got = mode.choose_sample(sizes, longest, bases, seed, 0, 0.15, 5)
        assert 0 in got                         # (a) the most reads
        big_long = max((c for c in range(n) if longest[c] > 2046),
                       key=lambda c: sizes[c])
        assert big_long in got                  # (b)
        small = min((c for c in range(n) if sizes[c] <= 5),
                    key=lambda c: (sizes[c], c))
        assert small in got                     # (c)
        share = sum(bases[c] for c in got) / sum(bases)
        assert 0.15 <= share < 0.15 + max(bases) / sum(bases)


def test_sets_are_the_toysets_clusters(tmp_path):
    """A pool set of the cell: the toyset's cluster counts, clusters.out in
    RATTLE's order, the same sizes for every seed and qualities that vary
    about the noise's error."""
    from gpubench import hpsio
    data = _cell_data()
    sets = []
    for seed in (2 ** 31 + 11, 2 ** 31 + 12):
        d = tmp_path / str(seed)
        d.mkdir()
        inputs, work = mode.make_inputs(str(d), data, seed, 0)
        reads = mode.read_fastq(inputs["fastq"])
        with open(inputs["clusters"], "rb") as fh:
            clusters = hpsio.loads(fh.read())
        lens = [len(r.seq) for r in reads]
        assert work == sum(lens) and len(reads) == 8192
        sizes = [len(m) for _main, m in clusters]
        assert len(sizes) == 546 and sum(s > 5 for s in sizes) == 175
        assert sum(s for s in sizes if s <= 5) == 739
        for main, m in clusters:
            ids = [i for i, _rev, _g in m]
            assert ids == sorted(ids, key=lambda i: (-lens[i], -i))
            assert main[0] == ids[int(len(ids) * 0.15)]
        first = [max(lens[i] for i, _r, _g in m) for _main, m in clusters]
        assert first == sorted(first, reverse=True)
        q = np.frombuffer(b"".join(r.qual for r in reads), np.uint8) - 33.0
        assert len(np.unique(q)) > 30
        assert 0.06 < np.mean(10 ** (-q / 10)) < 0.09
        sets.append((sorted(sizes), reads[0].seq))
    assert sets[0][0] == sets[1][0] and sets[0][1] != sets[1][1]


CFG_DATA = {"exponent": 1.5, "length_lo": 100, "length_hi": 400,
            "clusters": 12, "clusters_above": 8, "reads_below": 10,
            "quality": {"base": [16, 6], "error": [6, 3], "range": [1, 40]},
            "sample_share": 1.0}
TRAFFIC = {"mode": "correct", "pool": 2, "data": CFG_DATA}


def _config():
    """256 reads in 12 clusters: 8 of 6-128 reads and 4 of 2-3, which pass
    uncorrected, split into packs of at most 50 so that the large ones take
    the consensus of their packs' consensi."""
    cfg = small("rna_toyset", 256, 12)
    cfg["correct"] = dict(cfg["correct"], split=50)
    return cfg


@pytest.fixture
def own_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("RATTLE_POA_BACKEND", "native")
    return tmp_path


def _execute(seed=21, trace=0):
    return harness.execute(
        "correct", 1, _config(), TRAFFIC,
        [{"name": "correct_bases_per_s", "unit": "bases/s"}], seed, 0.0,
        trace, time.perf_counter(), device="cpu")


def test_sound_run_is_correct(own_tmp):
    out = _execute()
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    assert out["metrics"]["correct_bases_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(mode.CHECKS)


def _altered(orig):
    """An answer altered where it is produced: one base of the first read
    that a pack corrects."""
    def run(reads, aln, *a, **kw):
        cor, unc, cv = orig(reads, aln, *a, **kw)
        if cor:
            r = cor[0]
            r.seq = ("A" if r.seq[0] != "A" else "C") + r.seq[1:]
        return cor, unc, cv
    return run


def _unchanged(orig):
    """A step that returns its state unchanged: every read of a pack comes
    back as it went in, as its correction."""
    def run(reads, aln, *a, **kw):
        _cor, _unc, cv = orig(reads, aln, *a, **kw)
        return list(reads), [], cv
    return run


def _half(orig):
    """Half of the batch left out: the job corrects the first half of its
    packs."""
    def run(*a, **kw):
        packs, small_ = orig(*a, **kw)
        return packs[:len(packs) // 2], small_
    return run


def _no_quality_test(orig):
    """The quality test left out: every base unlike the consensus is
    replaced, whatever its own error."""
    def run(reads, aln, min_occ, gap_occ, _err_ratio):
        return orig(reads, aln, min_occ, gap_occ, float("inf"))
    return run


FAULTS = {"altered": ("rattle_tpu_torch.correct.runner", "correct_read_pack",
                      _altered),
          "no_quality_test": ("rattle_tpu_torch.correct.runner",
                              "correct_read_pack", _no_quality_test),
          "unchanged": ("rattle_tpu_torch.correct.runner",
                        "correct_read_pack", _unchanged),
          "half": ("rattle_tpu_torch.correct.driver", "build_packs", _half)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, own_tmp, monkeypatch):
    import importlib
    mod, attr, make = FAULTS[fault]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, make(getattr(m, attr)))
    out = _execute()
    assert not out["correct"]
    assert out["checks"]["jobs_differing"]["value"] == out["attempted"]
    assert out["checks"]["records_differing"]["value"] > 0
    if fault == "half":
        assert out["checks"]["reads_unaccounted"]["value"] > 0


@pytest.mark.parametrize("name", mode.CONTROLS)
def test_control_comes_out_not_correct(name, own_tmp):
    """The reference with E before F in its traceback, in the program's
    place in a whole run of the harness."""
    out = control.run_control({"name": "correct", "chips": 1}, _config(),
                              TRAFFIC, 23, name)
    assert not out["correct"]
    assert out["checks"]["records_differing"]["value"] > 0
    assert out["checks"]["reads_unaccounted"]["value"] == 0


def test_compare_counts_reads_and_consensi():
    rec = [ref.Record(f"@read{i},gene_cluster_{i // 3}", b"ACGT", b"IIII")
           for i in range(6)]
    cons = [ref.Record(f"@gene_cluster_{c} reads=3 labels=", b"ACG", b"KKK")
            for c in (0, 1)]
    info = b'{"clusters": [1], "sizes": [3, 3], "min_reads": 2, ' \
        b'"reads": ["read0", "read1", "read2", "read3", "read4", "read5"]}'

    def files(corrected, consensi):
        return {"corrected.fq": b"".join(r.fastq() for r in corrected),
                "uncorrected.fq": b"", "sample.json": info,
                "consensi.fq": b"".join(r.fastq() for r in consensi)}
    want = files(rec, cons)
    assert mode.compare(want, want) == {
        "jobs_differing": 0, "records_differing": 0, "reads_unaccounted": 0}
    # a record outside the sample differs: only the counts look at it
    other = [ref.Record(rec[0].header, b"TTTT", b"IIII")] + rec[1:]
    assert mode.compare(files(other, cons), want)["jobs_differing"] == 0
    # a read twice, one missing, a consensus missing
    dup = rec[:4] + [rec[3], rec[5]]
    assert mode.compare(files(dup, cons[:1]), want) == {
        "jobs_differing": 1, "records_differing": 2, "reads_unaccounted": 3}


def _record(mode_name):
    jobs = [dict(wall_s=w, work=1000, launches={"poa_align": 3,
                                                "poa_thread": 3}, stages={})
            for w in (10.0, 12.0)]
    traced = [dict(window=(0.0, 10.0),
                   device=[("void poa_align_kernel(int*)", 1.0, 5.0),
                           ("poa_thread_kernel<256>", 5.0, 6.0)], spans=[])]
    return dict(mode=mode_name, setup_s=30.0, span_s=22.0, work=2000,
                jobs=jobs, traced=traced)


NEW = ("correct_bases_per_s", "poa_align_ms", "idle_share.correct",
       "launches.correct", "job_s_p90.correct", "job_device_ms.correct")


@pytest.mark.parametrize("name,want", zip(NEW, (2000 / 22.0, 4000.0, 50.0,
                                                6.0, 12.0, 5000.0)))
def test_readers_read_correct_runs_only(name, want):
    read = harness.reader(name)
    assert read(_record("correct")) == pytest.approx(want)
    assert read(_record("cluster")) is None
    assert harness.reader("cluster_reads_per_s")(_record("correct")) is None


def test_the_mode_and_reference_import_nothing_of_the_program():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("reference/correct.py", "modes/correct.py"):
        names = imported(os.path.join(here, rel))
        assert not names & {"rattle_tpu_torch", "rattle_tpu", "torch",
                            "jax"}, rel
    src = open(os.path.join(here, "reference", "poa_ref.c")).read()
    assert set(l for l in src.splitlines() if l.startswith("#include")) == {
        "#include <stdint.h>", "#include <stdlib.h>", "#include <string.h>"}
