"""The plain reference against the port's scalar oracle, and the control
that the comparison has to tell apart from it, at sizes a test run holds."""

import pytest

from gpubench import control, synth
from gpubench.modes import cluster as mode
from gpubench.reference import cluster as ref

from .conftest import small


@pytest.mark.parametrize("rna,seed", [(True, 1), (False, 2), (True, 5)])
def test_reference_matches_the_scalar_oracle(rna, seed):
    from rattle_tpu_torch.cluster import oracle
    from rattle_tpu_torch.config import ClusterParams
    reads = synth.synthetic_reads(160, 24, [seed, 0, 0],
                                  revcomp=0.0 if rna else 0.5)
    seqs = sorted([s for _n, s, _g in reads], key=lambda s: -len(s))
    got = ref.Reference(seqs, ref.Params(rna=rna)).cluster()
    want = [((c.main_seq.seq_id, c.main_seq.rev),
             [(s.seq_id, s.rev) for s in c.seqs])
            for c in oracle.cluster_reads(seqs, ClusterParams(is_rna=rna))]
    assert got == want


def test_lockstep_and_one_by_one_agree(monkeypatch):
    reads = synth.synthetic_reads(120, 12, [9, 0, 0])
    seqs = sorted([s for _n, s, _g in reads], key=lambda s: -len(s))
    base = ref.Reference(seqs, ref.Params(rna=True)).cluster()
    monkeypatch.setattr(ref, "LOCKSTEP_ROWS", 10 ** 9)
    one = ref.Reference(seqs, ref.Params(rna=True)).cluster()
    monkeypatch.setattr(ref, "LOCKSTEP_ROWS", 1)
    monkeypatch.setattr(ref, "BLOCK_SEEDS", 3)
    lock = ref.Reference(seqs, ref.Params(rna=True)).cluster()
    assert base == one == lock


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
