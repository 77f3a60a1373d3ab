"""The port's copy of the host engine (cluster/host_engine.py) against the
JAX package's HostClusterEngine and the NumPy oracle: identical clusters.
Nothing in the port selects it on its own."""

import ast
import os

import numpy as np
import pytest

from rattle_tpu.cluster import oracle
from rattle_tpu.cluster.host_engine import HostClusterEngine as JaxHost
from rattle_tpu.cluster.host_engine import cluster_reads_host as jax_host
from rattle_tpu.config import ClusterParams as JaxParams
from rattle_tpu_torch.cluster.host_engine import (HostClusterEngine,
                                                  cluster_reads_host)
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops.encode import reverse_complement_str
from tests.conftest import make_read, mutate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sig(clusters):
    return [(c.main_seq.seq_id, c.main_seq.rev,
             [(s.seq_id, s.rev) for s in c.seqs]) for c in clusters]


def _reads(seed, n_fam, per, err=0.1, revcomp=False):
    """Length-sorted reads from a few synthetic transcripts."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        ref = make_read(rng, int(rng.integers(200, 380)))
        for _ in range(per):
            s = mutate(rng, ref, err)
            if revcomp and rng.random() < 0.5:
                s = reverse_complement_str(s)
            seqs.append(s)
    seqs.sort(key=lambda s: -len(s))
    return seqs


CASES = {
    "rna": dict(seed=51, n_fam=6, per=10, kw=dict(is_rna=True)),
    "cdna": dict(seed=52, n_fam=6, per=10, revcomp=True,
                 kw=dict(is_rna=False)),
    "iso": dict(seed=53, n_fam=4, per=14, err=0.04,
                kw=dict(kmer_size=11, t_s=0.3, t_v=25.0, is_rna=True)),
    "rna_96": dict(seed=54, n_fam=8, per=12, kw=dict(is_rna=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_engine_matches_jax_and_oracle(case):
    c = CASES[case]
    seqs = _reads(c["seed"], c["n_fam"], c["per"], c.get("err", 0.1),
                  c.get("revcomp", False))
    assert len(seqs) >= 48
    params = ClusterParams(**c["kw"])
    got = _sig(HostClusterEngine(seqs, params).cluster())
    assert got == _sig(oracle.cluster_reads(seqs, JaxParams(**c["kw"])))
    assert got == _sig(JaxHost(seqs, JaxParams(**c["kw"])).cluster())


def test_cluster_reads_host_small_input_is_the_oracle():
    """Below 8 reads the entry point hands over to the oracle, like the
    JAX one."""
    seqs = _reads(55, 2, 3)
    params = ClusterParams(is_rna=True)
    got = _sig(cluster_reads_host(seqs, params))
    assert got == _sig(jax_host(seqs, JaxParams(is_rna=True)))
    assert got == _sig(oracle.cluster_reads(seqs, JaxParams(is_rna=True)))


def test_no_port_module_selects_the_host_engine():
    """The host engine is reached only by an explicit import: no other
    module of the port (or chip_smoke.py) imports it."""
    users = []
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "rattle_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    "host_engine" in node.module:
                users.append(path)
            elif isinstance(node, ast.ImportFrom) and any(
                    a.name == "host_engine" for a in node.names):
                users.append(path)
    assert users == []
