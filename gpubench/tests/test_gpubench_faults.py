"""A whole run of the harness on the CPU (the look for a card skipped), at a
size a test run holds: correct with the program as it is, not correct with
the timed path broken underneath in each way a cluster cell can be."""

import time

import pytest

from gpubench import harness

from .conftest import small

TRAFFIC = {"mode": "cluster", "pool": 2, "data": {}}


def _altered(orig):
    """An answer altered where it is produced: one read moved to another
    cluster in the engine's output."""
    def run(seqs, params, **kw):
        out = orig(seqs, params, **kw)
        src = next(c for c in out if len(c.seqs) > 1)
        moved = src.seqs.pop()
        next(c for c in out if c is not src).seqs.append(moved)
        return out
    return run


def _unchanged(orig):
    """A step that returns its state unchanged: the engine hands back every
    read as its own cluster."""
    from rattle_tpu_torch.io.hpsio import Cluster, CSeq

    def run(seqs, params, **kw):
        return [Cluster(CSeq(i, False), [CSeq(i, False)])
                for i in range(len(seqs))]
    return run


def _half(orig):
    """Half of the batch left out: the job clusters the first half of its
    reads."""
    def run(*a, **kw):
        reads = orig(*a, **kw)
        return reads[:len(reads) // 2]
    return run


FAULTS = {"altered": ("rattle_tpu_torch.cluster.bulk", "cluster_reads_bulk",
                      _altered),
          "unchanged": ("rattle_tpu_torch.cluster.bulk", "cluster_reads_bulk",
                        _unchanged),
          "half": ("rattle_tpu_torch.pipeline.stages", "load_cluster_inputs",
                   _half)}


def _execute(config="rna_toyset", trace=0, traffic=TRAFFIC):
    return harness.execute("faults", 1, small(config, 64, 8), traffic,
                           [{"name": "cluster_reads_per_s", "unit": "reads/s"}],
                           21, 0.0, trace, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("config", ["rna_toyset", "cdna_toyset"])
def test_sound_run_is_correct(config):
    out = _execute(config)
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    assert out["metrics"]["cluster_reads_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_sound_run_on_two_labelled_samples_is_correct():
    """A mix's ``samples`` splits each set into labelled fastq files
    (``-i a.fq,b.fq -l S0,S1``), which the reference reads in turn."""
    out = _execute(traffic=dict(TRAFFIC, data={"samples": 2}))
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    import importlib
    mod, attr, make = FAULTS[fault]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, make(getattr(m, attr)))
    out = _execute()
    assert not out["correct"]
    assert out["checks"]["jobs_differing"]["value"] == out["attempted"]
    assert out["checks"]["reads_misplaced"]["value"] > 0
