"""The engine's cluster bookkeeping on arrays (cluster/bulk.py
``main_positions``, ``ClusterArrays``) against the object rebuild it
replaces: oracle.get_main_seq over CSeq lists, cluster by cluster."""

import numpy as np
import pytest

from rattle_tpu_torch.cluster import oracle
from rattle_tpu_torch.cluster.bulk import ClusterArrays, main_positions
from rattle_tpu_torch.io.hpsio import Cluster, CSeq

PERCENTILES = (0.0, 0.15, 0.99)
# how each case's clusters are drawn (``_cluster_case``)
KINDS = ("single", "equal_lengths", "other_strand", "last_matches",
         "last_differs", "random")
SEEDS_A_CASE = 20


def _sig(clusters):
    return [(c.main_seq.seq_id, c.main_seq.rev,
             [(s.seq_id, s.rev) for s in c.seqs]) for c in clusters]


def _cluster_case(rng, kind, p):
    """Reads ``lens`` and clusters as CSeq lists, each list's first entry
    its ``old``; ``kind`` fixes the strands relative to the walk that
    get_main_seq makes from int(size * p) over the sorted members."""
    n_cl = int(rng.integers(1, 7))
    sizes = np.ones(n_cl, np.int64) if kind == "single" else \
        rng.integers(1, 21, n_cl)
    n = int(sizes.sum())
    lens = np.full(n, 500) if kind == "equal_lengths" else \
        rng.integers(300, 300 + int(rng.choice([2, 5, 1000])), n)
    ids = rng.permutation(n)
    lists, at = [], 0
    for size in sizes.tolist():
        mem = ids[at:at + size]
        at += size
        srt = mem[np.lexsort((-mem, -lens[mem]))]   # get_main_seq's order
        j0 = int(size * p)
        rev = rng.random(size) < 0.5
        if kind == "other_strand":
            old_k = int(rng.integers(size))
            rev[:] = not rev[old_k]
            rev[old_k] = not rev[old_k]
        elif kind in ("last_matches", "last_differs"):
            # nothing on old's strand from j0 up to the last index
            old_k = 0 if j0 > 0 else size - 1
            want = bool(rev[old_k])
            rev[j0:size - 1] = not want
            rev[old_k] = want
            if size - 1 != old_k:
                rev[size - 1] = want if kind == "last_matches" else not want
        else:
            old_k = int(rng.integers(size))
        seqs = [CSeq(int(i), bool(r)) for i, r in zip(srt, rev)]
        lists.append([seqs[old_k]] + seqs[:old_k] + seqs[old_k + 1:])
    return lens, lists


@pytest.mark.parametrize("p", PERCENTILES)
@pytest.mark.parametrize("kind", KINDS)
def test_main_positions_match_get_main_seq(kind, p):
    """Member order and representative (id and strand) of every cluster,
    SEEDS_A_CASE seeded cases a kind and percentile."""
    for seed in range(SEEDS_A_CASE):
        rng = np.random.default_rng([KINDS.index(kind), int(p * 100), seed])
        lens, lists = _cluster_case(rng, kind, p)
        n = len(lens)
        cid = np.empty(n, np.int64)
        rev = np.empty(n, bool)
        old = np.array([lst[0].seq_id for lst in lists])
        for c, lst in enumerate(lists):
            for s in lst:
                cid[s.seq_id], rev[s.seq_id] = c, s.rev
        order = np.lexsort((-np.arange(n), -lens, cid))
        starts = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
        main = main_positions(order, starts, rev, old, p)
        for c, lst in enumerate(lists):
            old_c = lst[0]
            want = oracle.get_main_seq(lst, lens.tolist(), p)
            got = order[starts[c]:starts[c + 1]]
            assert got.tolist() == [s.seq_id for s in lst], (seed, c)
            assert starts[c] <= main[c] < starts[c + 1]
            assert (order[main[c]], rev[order[main[c]]]) == \
                (want.seq_id, want.rev), (seed, c)
            if kind in ("single", "other_strand", "last_matches",
                        "last_differs"):
                assert want is old_c


def _python_merge(clusters, owner, revf, lens, p):
    """The object rebuild of one merge round (cluster.cpp:171-256)."""
    groups = {}
    for c in range(len(clusters)):
        groups.setdefault(int(owner[c]), []).append((c, bool(revf[c])))
    out = []
    for seed in sorted(groups):
        merged = Cluster(CSeq(-1, False), [])
        for c, flip in groups[seed]:
            for s in clusters[c].seqs:
                merged.seqs.append(CSeq(s.seq_id, s.rev != flip))
        merged.main_seq = oracle.get_main_seq(merged.seqs, lens, p)
        out.append(merged)
    return out


def _random_pass(rng, m):
    """A greedy pass's result over m units: each non-seed claimed by an
    earlier seed, strand flags random (a seed's own flag included)."""
    owner = np.arange(m)
    seeds = [0]
    for u in range(1, m):
        if rng.random() < 0.4:
            owner[u] = seeds[int(rng.integers(len(seeds)))]
        else:
            seeds.append(u)
    return owner, rng.random(m) < 0.5


@pytest.mark.parametrize("p", PERCENTILES)
@pytest.mark.parametrize("seed", range(4))
def test_merge_rounds_from_arrays_match_object_rebuild(seed, p):
    """A greedy pass over single reads, then merge rounds with flipped
    member clusters, on arrays and by the object rebuild: the same
    clusters after every round, and a round trip through the objects (a
    checkpoint's resume) gives the arrays back."""
    rng = np.random.default_rng([seed, int(p * 100)])
    n = int(rng.integers(40, 120))
    lens = rng.integers(300, 300 + int(rng.choice([3, 1000])), n)
    st = ClusterArrays.singletons(n)
    objs = [Cluster(CSeq(i, False), [CSeq(i, False)]) for i in range(n)]
    while True:
        reps = st.reps()
        assert reps.tolist() == [c.main_seq.seq_id for c in objs]
        owner, revf = _random_pass(rng, len(reps))
        st = st.merged(owner, revf, lens, p)
        objs = _python_merge(objs, owner, revf, lens.tolist(), p)
        got = st.to_clusters()
        assert _sig(got) == _sig(objs)
        assert all(any(m is c.main_seq for m in c.seqs) for c in got)
        back = ClusterArrays.of_clusters(got, n)
        for f in ("cid", "rev", "order", "starts", "main"):
            assert np.array_equal(getattr(back, f), getattr(st, f)), f
        if len(objs) == 1:
            break
