"""The plain reference against the port's scalar oracle, and the control
that the comparison has to tell apart from it, at sizes a test run holds."""

import bisect

import numpy as np
import pytest

from gpubench import control, synth
from gpubench.modes import cluster as mode
from gpubench.reference import cluster as ref

from .conftest import small


def _sorted_reads(n, genes, seed, rna, exponent=0.8):
    reads = synth.synthetic_reads(n, genes, [seed, 0, 0], exponent=exponent,
                                  revcomp=0.0 if rna else 0.5)
    return sorted([s for _n, s, _g in reads], key=lambda s: -len(s))


@pytest.mark.parametrize("rna,seed,exponent", [
    pytest.param(rna, seed, exponent, id=f"{rna}-{seed}" + (
        "-flat" if exponent == 0 else ""))
    for rna, seed, exponent in [(True, 1, 0.8), (False, 2, 0.8),
                                (True, 5, 0.8), (False, 3, 0.8),
                                (True, 4, 0.0), (False, 6, 0.0)]])
def test_reference_matches_the_scalar_oracle(rna, seed, exponent):
    from rattle_tpu_torch.cluster import oracle
    from rattle_tpu_torch.config import ClusterParams
    seqs = _sorted_reads(160, 24, seed, rna, exponent)
    got = ref.Reference(seqs, ref.Params(rna=rna)).cluster()
    want = [((c.main_seq.seq_id, c.main_seq.rev),
             [(s.seq_id, s.rev) for s in c.seqs])
            for c in oracle.cluster_reads(seqs, ClusterParams(is_rna=rna))]
    assert got == want


def _lis_filter_one(m1, m2, k):
    """similarity.cpp:4-97 for one pair, one match at a time: (bases,
    distances)."""
    n = len(m1)
    p = [0] * n
    m = [0] * (n + 1)
    tails = [0]
    length = 0
    for i in range(n):
        v = m2[i]
        new_l = bisect.bisect_left(tails, v, 1, length + 1)
        p[i] = m[new_l - 1]
        m[new_l] = i
        if new_l > length:
            length = new_l
            tails.append(v)
        else:
            tails[new_l] = v
    s = [0] * length
    j = m[length]
    for i in range(length - 1, -1, -1):
        s[i] = j
        j = p[j]
    bases, dists = 0, []
    lf = ls = 0
    for i in range(length):
        a1, a2 = m1[s[i]], m2[s[i]]
        if i == 0:
            lf, ls, bases = a1, a2, k
            continue
        d1, d2 = a1 - lf, a2 - ls
        if (d1 < k and d2 < k) or (d1 >= k and d2 >= k):
            ex = k - (a2 - m2[s[i - 1]])
            bases += k - ex if ex > 0 else k
            dists.append(d2 - d1)
            lf, ls = a1, a2
    return bases, dists


def _variance(d):
    """utils.cpp:26-55, one sum at a time: var([]) = 0, var([x]) = NaN."""
    if not d:
        return 0.0
    res = 0.0
    for x in d:
        res += float(x)
    mean = res / len(d)
    ss = comp = 0.0
    for x in d:
        dv = float(x) - mean
        ss += dv * dv
        comp += dv
    num = ss - comp * comp / len(d)
    return num / (len(d) - 1) if len(d) > 1 else float("nan")


def test_lockstep_and_one_by_one_agree():
    """The C LIS over many pairs' match lists in one call, against the
    statement of similarity.cpp and utils.cpp one match at a time, on seeded
    lists by (pos1, pos2): colinear runs with noise, ties in pos1, empty and
    single matches."""
    rng = np.random.default_rng(17)
    m1s, m2s = [], []
    for _pair in range(400):
        n = int(rng.choice([0, 1, 2, 3, 20, 200, 900]))
        a = np.sort(rng.integers(0, 3000, n))
        b = np.where(rng.random(n) < 0.7, a + rng.integers(-40, 40, n),
                     rng.integers(0, 3000, n))
        order = np.lexsort((b, a))
        m1s.append(a[order])
        m2s.append(np.maximum(b[order], 0))
    off = np.concatenate([[0], np.cumsum([len(x) for x in m1s])])
    bases, var = ref.lis_filter(off, np.concatenate(m1s), np.concatenate(m2s),
                                10)
    for i, (a, b) in enumerate(zip(m1s, m2s)):
        want_b, dists = _lis_filter_one(a.tolist(), b.tolist(), 10)
        assert bases[i] == want_b
        np.testing.assert_array_equal(var[i], _variance(dists))


@pytest.mark.parametrize("rna", [True, False])
def test_threads_give_the_same_clusters(rna, monkeypatch):
    """1, 4 and 16 threads (more than the cores), the last loading the
    library anew while its threads start."""
    from gpubench.reference import native
    seqs = _sorted_reads(300, 30, 9, rna)
    one = ref.Reference(seqs, ref.Params(rna=rna), workers=1).cluster()
    four = ref.Reference(seqs, ref.Params(rna=rna), workers=4).cluster()
    monkeypatch.setattr(native, "_LIBS", {})
    many = ref.Reference(seqs, ref.Params(rna=rna), workers=16).cluster()
    assert one == four == many


@pytest.mark.parametrize("rna", [True, False])
def test_small_blocks_and_chunks_give_the_same_clusters(rna, monkeypatch):
    """Blocks of one or two seeds, reads hashed seven at a time."""
    seqs = _sorted_reads(200, 16, 13, rna)
    base = ref.Reference(seqs, ref.Params(rna=rna), workers=3).cluster()
    monkeypatch.setattr(ref, "BLOCK_SEEDS", (1, 2))
    monkeypatch.setattr(ref, "CHUNK", 7)
    assert ref.Reference(seqs, ref.Params(rna=rna), workers=3).cluster() \
        == base


def test_schedule_is_the_reference_binarys():
    assert ref.schedule(ref.Params()) == [0.35000000000000003,
                                          0.30000000000000004,
                                          0.25000000000000006,
                                          0.20000000000000007, 0.0]
    assert ref.schedule(ref.Params(bv_start=0.4, bv_end=0.4)) == []


@pytest.mark.parametrize("config", ["rna_toyset", "cdna_toyset"])
def test_control_comes_out_not_correct(config):
    """The reference with each pair's matches cut at 128 (the program's
    first tier without its rescue), in the program's place in a whole run
    of the harness."""
    cfg = small(config, 150, 15)
    traffic = {"mode": "cluster", "pool": 2, "data": {}}
    for seed in (11, 12):
        out = control.run_control({"name": "test", "chips": 1}, cfg, traffic,
                                  seed, "match_cap")
        assert not out["correct"] and out["failed"] == 2
        checks = out["checks"]
        assert checks["jobs_differing"]["value"] == 2
        assert checks["reads_misplaced"]["value"] > 0


def test_compare_counts_misplaced_reads():
    a = [((0, False, -1), [(0, False, -1), (1, False, -1)]),
         ((2, False, -1), [(2, False, -1)])]
    b = [((0, False, -1), [(0, False, -1)]),
         ((2, False, -1), [(2, False, -1), (1, True, -1)])]
    from gpubench import hpsio

    def out(cl):
        return {"clusters.out": hpsio.dumps(cl)}
    assert mode.compare(out(a), out(a)) == \
        {"jobs_differing": 0, "reads_misplaced": 0}
    assert mode.compare(out(b), out(a)) == \
        {"jobs_differing": 1, "reads_misplaced": 1}
    assert hpsio.loads(hpsio.dumps(b)) == b


def test_format_reads_the_programs_writer(tmp_path):
    from rattle_tpu_torch.io import hpsio as prog
    cl = [prog.Cluster(prog.CSeq(3, True), [prog.CSeq(3, True), prog.CSeq(1, False)])]
    prog.write_clusters(cl, str(tmp_path / "c.out"))
    data = (tmp_path / "c.out").read_bytes()
    from gpubench import hpsio
    assert hpsio.dumps(hpsio.loads(data)) == data
    assert hpsio.loads(data) == [((3, True, -1), [(3, True, -1),
                                                   (1, False, -1)])]


def test_judge_combines_each_check_over_the_jobs():
    from gpubench import harness
    a = [((0, False, -1), [(0, False, -1), (1, False, -1), (2, True, -1)])]
    b = [((0, False, -1), [(0, False, -1)]),
         ((1, False, -1), [(1, False, -1), (2, True, -1)])]
    from gpubench import hpsio
    oa, ob = ({"clusters.out": hpsio.dumps(c)} for c in (a, b))
    checks, failed = harness.judge(mode, [(oa, oa), (ob, oa), (ob, oa)])
    assert failed == 2
    assert checks == {"jobs_differing": {"value": 2, "limit": 0},
                      "reads_misplaced": {"value": 2, "limit": 0}}
