"""The port's BulkClusterEngine on the CPU vs the JAX BulkClusterEngine and
the NumPy oracle: identical clusters (``_sig`` as in
tests/test_bulk_engine.py)."""

import numpy as np
import pytest
import torch

from rattle_tpu.cluster import oracle
from rattle_tpu.cluster.bulk import BulkClusterEngine as JaxEngine
from rattle_tpu.config import ClusterParams as JaxParams
from rattle_tpu.ops.encode import reverse_complement_str
from rattle_tpu.ops.sketch_device import build_device_sketch as jax_sketch
from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.cluster.bulk import BulkClusterEngine, cluster_reads_bulk
from rattle_tpu_torch.config import ClusterParams, bv_threshold_schedule
from rattle_tpu_torch.io.hpsio import write_clusters
from rattle_tpu_torch.ops.sketch_device import sketch_from_numpy
from rattle_tpu_torch.utils import metrics
from rattle_tpu_torch.utils.checkpoint import ClusterCheckpoint
from tests.conftest import make_read, mutate

# the engine's plain kernel versions are many small torch ops; the run has
# several workers
torch.set_num_threads(1)


def _sig(clusters):
    return [(c.main_seq.seq_id, c.main_seq.rev,
             [(s.seq_id, s.rev) for s in c.seqs]) for c in clusters]


def _families(seed, n_fam=6, per=(6, 14), lo=200, hi=380, err=0.1,
              revcomp=False):
    """Length-sorted reads from a few synthetic transcripts."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        ref = make_read(rng, int(rng.integers(lo, hi)))
        for _ in range(int(rng.integers(*per))):
            s = mutate(rng, ref, err)
            if revcomp and rng.random() < 0.5:
                s = reverse_complement_str(s)
            seqs.append(s)
    seqs.sort(key=lambda s: -len(s))
    return seqs


def _params(**kw):
    return ClusterParams(**kw), JaxParams(**kw)


CASES = {
    "rna": dict(seed=1, kw=dict(is_rna=True)),
    "cdna": dict(seed=2, kw=dict(is_rna=False), revcomp=True),
    "iso": dict(seed=3, kw=dict(kmer_size=11, t_s=0.3, t_v=25.0,
                                is_rna=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine_and_oracle(case):
    c = CASES[case]
    seqs = _families(c["seed"], revcomp=c.get("revcomp", False))
    params, jparams = _params(**c["kw"])
    golden = _sig(oracle.cluster_reads(seqs, params))
    got = BulkClusterEngine(seqs, params, device="cpu").cluster()
    assert _sig(got) == golden
    assert _sig(JaxEngine(seqs, jparams).cluster()) == golden


def test_engine_rare_path_all_borderline():
    """Every score-passing pair goes through the borderline-variance rare
    path (host f64 rescore + patch): no pair decides on the device."""
    seqs = _families(4)
    params = ClusterParams(is_rna=True)
    eng = BulkClusterEngine(seqs, params, device="cpu")
    eng.var_band = np.float32(1e12)
    got = eng.cluster()
    assert eng.n_oracle_fallbacks > 0
    assert _sig(got) == _sig(oracle.cluster_reads(seqs, params))


def test_engine_rare_path_overflow_tier():
    """A one-entry M ladder sends every pair with more matches than the first
    tier through the overflow route (exact host scorer)."""
    seqs = _families(5, err=0.04)
    params = ClusterParams(is_rna=False)
    eng = BulkClusterEngine(seqs, params, device="cpu")
    eng.m_ladder = (eng.m_ladder[0],)
    got = eng.cluster()
    assert eng.n_oracle_fallbacks > 0
    assert _sig(got) == _sig(oracle.cluster_reads(seqs, params))


def test_engine_cache_free_sweep_tiles(monkeypatch, tmp_path):
    """Above CACHE_MAX_N reads the engine keeps no score cache (merge rounds
    score representative pairs again), and a block's seeds sweep the rest
    of the pool in SWEEP_TILE-column tiles.  Both lowered, with blocks of 16
    reads, a 64-read input takes both paths: clusters.out is the oracle's
    byte for byte."""
    monkeypatch.setattr(bulk, "CACHE_MAX_N", 32)
    monkeypatch.setattr(bulk, "SWEEP_TILE", 16)
    seqs = _families(9, n_fam=8, per=(8, 10), err=0.08)[:64]
    params = ClusterParams(is_rna=True)
    eng = BulkClusterEngine(seqs, params, device="cpu")
    assert len(seqs) == 64 and eng.sweep_cpad == 16
    assert all(c is None for c in eng._cache.values())
    eng.k_block = 16
    waves = []
    wave = eng._wave
    monkeypatch.setattr(eng, "_wave", lambda rows, cols, *a, **kw: (
        waves.append((len(rows), len(cols), kw.get("ordered", a[-1]))),
        wave(rows, cols, *a, **kw))[1])
    paths = {name: str(tmp_path / name) for name in ("engine", "oracle")}
    write_clusters(eng.cluster(), paths["engine"])
    write_clusters(oracle.cluster_reads(seqs, params), paths["oracle"])
    sweeps = [c for _r, c, ordered in waves if not ordered]
    assert sweeps and max(sweeps) == 16   # the sweep ran in 16-column tiles
    with open(paths["engine"], "rb") as a, open(paths["oracle"], "rb") as b:
        assert a.read() == b.read()


def test_engine_merge_round_nonidentity_gather():
    """Merge rounds gather sketch rows by representative read id (a
    non-identity map) on a 48-256-read input."""
    seqs = _families(6, n_fam=8, per=(6, 7), lo=200, hi=300, err=0.12)[:50]
    seqs.sort(key=lambda s: -len(s))
    params, jparams = _params(is_rna=True)
    got = _sig(BulkClusterEngine(seqs, params, device="cpu").cluster())
    assert got == _sig(oracle.cluster_reads(seqs, params))
    assert got == _sig(JaxEngine(seqs, jparams).cluster())


def test_engine_on_jax_sketch():
    """The port's engine on the JAX engine's own tables, carried over by
    sketch_from_numpy, gives the JAX engine's clusters."""
    seqs = _families(7, revcomp=True)
    params, jparams = _params(is_rna=False)
    jsk = jax_sketch(seqs, 10, True)
    sk = sketch_from_numpy(
        *(np.asarray(getattr(jsk, f)) for f in
          ("hbp", "hs", "ps", "plane", "nk", "lens", "bvc")),
        rev_hs=np.asarray(jsk.rev_hs), rev_ps=np.asarray(jsk.rev_ps),
        rev_plane=np.asarray(jsk.rev_plane), kmer_size=10, device="cpu")
    got = BulkClusterEngine(seqs, params, sketch=sk, device="cpu").cluster()
    assert _sig(got) == _sig(JaxEngine(seqs, jparams, sketch=jsk).cluster())


def test_engine_groups_and_checkpoint_resume(tmp_path):
    """--iso batching (groups) and a resume after a crash mid-merge both give
    the uninterrupted, per-group result."""
    seqs = _families(8, n_fam=5, per=(10, 14))
    params = ClusterParams(is_rna=True)
    groups = np.repeat([0, 1], [len(seqs) // 2, len(seqs) - len(seqs) // 2])
    want = cluster_reads_bulk(seqs, params, groups=groups, device="cpu")
    per_group = []
    for g in (0, 1):
        idx = np.nonzero(groups == g)[0]
        for c in oracle.cluster_reads([seqs[i] for i in idx], params):
            per_group.append((int(idx[c.main_seq.seq_id]), c.main_seq.rev,
                              [(int(idx[s.seq_id]), s.rev) for s in c.seqs]))
    assert _sig(want) == per_group

    class Crash(Exception):
        pass

    class CrashingCheckpoint(ClusterCheckpoint):
        def record(self, phases_done, clusters):
            super().record(phases_done, clusters)
            if phases_done == 2:
                raise Crash()

    ck_dir = str(tmp_path / "ck")
    eng = BulkClusterEngine(seqs, params, groups=groups, device="cpu")
    eng.checkpoint = CrashingCheckpoint(ck_dir, "k")
    with pytest.raises(Crash):
        eng.cluster()
    eng = BulkClusterEngine(seqs, params, groups=groups, device="cpu")
    eng.checkpoint = ClusterCheckpoint(ck_dir, "k")
    assert eng.checkpoint.load()[0] == 2
    assert _sig(eng.cluster()) == _sig(want)


@pytest.mark.parametrize("case", ["cdna", "groups"])
def test_engine_merge_rounds_on_many_families(case, tmp_path):
    """281 cDNA reads over 30 families at 14% error, half reverse-complemented:
    the greedy pass splits the families and every merge round joins
    clusters.  The oracle's clusters, signature for signature (for
    ``groups``: three groups of ten families, each its own oracle run), one
    ``List[Cluster]`` built a run (``cluster.materialize``), and with a
    checkpoint one more for each recorded phase and the same clusters."""
    seqs = _families(11, n_fam=30, per=(8, 12), err=0.14, revcomp=True)
    params = ClusterParams(is_rna=False)
    groups = None
    if case == "groups":
        # contiguous groups, each length-sorted, as --iso hands them over
        g_of = np.random.default_rng(11).integers(0, 3, len(seqs))
        idx = np.concatenate([np.nonzero(g_of == g)[0] for g in range(3)])
        seqs = [seqs[i] for i in idx]
        groups = g_of[idx]
    eng = BulkClusterEngine(seqs, params, groups=groups, device="cpu")
    merged = []
    greedy_pass = eng._greedy_pass

    def counting_pass(ids, threshold):
        owner, revf = greedy_pass(ids, threshold)
        merged.append(len(ids) - len(np.unique(owner)))
        return owner, revf

    eng._greedy_pass = counting_pass
    before = metrics.GLOBAL.counters.get("cluster.materialize", 0)
    got = _sig(eng.cluster())
    assert metrics.GLOBAL.counters["cluster.materialize"] - before == 1
    schedule = bv_threshold_schedule(params)
    assert len(merged) == 1 + len(schedule)
    assert sum(m > 0 for m in merged[1:]) >= 3, merged
    want = []
    for g in ([None] if groups is None else range(3)):
        idx = np.arange(len(seqs)) if g is None else np.nonzero(groups == g)[0]
        for c in oracle.cluster_reads([seqs[i] for i in idx], params):
            want.append((int(idx[c.main_seq.seq_id]), c.main_seq.rev,
                         [(int(idx[s.seq_id]), s.rev) for s in c.seqs]))
    assert got == want

    records = []

    class CountingCheckpoint(ClusterCheckpoint):
        def record(self, phases_done, clusters):
            records.append(phases_done)
            super().record(phases_done, clusters)

    eng = BulkClusterEngine(seqs, params, groups=groups, device="cpu")
    eng.checkpoint = CountingCheckpoint(str(tmp_path / "ck"), "k")
    before = metrics.GLOBAL.counters["cluster.materialize"]
    assert _sig(eng.cluster()) == got
    assert records == list(range(1, len(schedule) + 2))
    assert metrics.GLOBAL.counters["cluster.materialize"] - before == \
        1 + len(records)


def test_replays_match_jax():
    """greedy_owner (block replay) and absorb_rest (sweep first-claim) on
    random win matrices, against the JAX versions."""
    import jax.numpy as jnp
    import torch
    from rattle_tpu.cluster import bulk as jbulk
    from rattle_tpu_torch.cluster import bulk as tbulk
    rng = np.random.default_rng(11)
    for n, n_valid in ((64, 64), (96, 70)):
        w = rng.choice(np.array([0, 1, 2], np.int8), (n, n), p=[.9, .04, .06])
        w = np.triu(w, 1)
        w[n_valid:] = 0
        w[:, n_valid:] = 0
        ref = np.asarray(jbulk.greedy_owner(jnp.asarray(w),
                                            jnp.int32(n_valid)))
        got = tbulk.greedy_owner(torch.from_numpy(w), n_valid).numpy()
        np.testing.assert_array_equal(got, ref)
    w = rng.choice(np.array([0, 1, 2], np.int8), (40, 300), p=[.97, .01, .02])
    np.testing.assert_array_equal(
        tbulk.absorb_rest(torch.from_numpy(w)).numpy(),
        np.asarray(jbulk.absorb_rest(jnp.asarray(w))))
    # absorb_rest's plain version (the kernel's, on the card) on a column
    # won only by its last row, an empty column, one row, and dense wins
    from rattle_tpu_torch.ops import kernels
    last = np.zeros((50, 7), np.int8)
    last[-1, 2], last[-1, 4], last[10, 5] = 1, 2, 2
    for w in (last, np.zeros((8, 5), np.int8), w[:1],
              rng.choice(np.array([0, 1, 2], np.int8), (300, 40))):
        np.testing.assert_array_equal(
            kernels.absorb_rest_plain(torch.from_numpy(w)).numpy(),
            np.asarray(jbulk.absorb_rest(jnp.asarray(w))))


def test_greedy_owner_plain_matches_jax_full_block():
    """The block replay's plain version against JAX's ``greedy_owner`` at
    the block size K = 4,096 with n_valid < K: random wins in both
    triangles and past n_valid (masked by both), and a late seed that wins
    every later read, so owns every read after it that is still its own."""
    import jax.numpy as jnp
    from rattle_tpu.cluster import bulk as jbulk
    from rattle_tpu_torch.ops import kernels
    rng = np.random.default_rng(4096)
    k, n_valid = 4096, 4000
    w = rng.choice(np.array([0, 1, 2], np.int8), (k, k),
                   p=[0.998, 0.001, 0.001])
    w[3000, 3001:] = rng.choice(np.array([1, 2], np.int8), k - 3001)
    w[:3000, 3000] = 0                  # so that read 3000 is a seed
    ref = np.asarray(jbulk.greedy_owner(jnp.asarray(w), jnp.int32(n_valid)))
    got = kernels.greedy_owner_plain(torch.from_numpy(w), n_valid).numpy()
    np.testing.assert_array_equal(got, ref)
    owner = got >> 1
    assert (owner[3001:n_valid] <= 3000).all() and owner[3000] == 3000
    np.testing.assert_array_equal(got[n_valid:], np.arange(n_valid, k) << 1)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        kernels.greedy_owner(torch.from_numpy(w), n_valid).numpy(), ref)


def test_score_decide_plain_matches_jax_score_body(monkeypatch):
    """``score_decide``'s plain version against the decision half of JAX's
    ``_score_body``: its join and LIS kernel are replaced by fixed outputs,
    so the same (bases, var, total) reach both decisions.  var sits at
    t_v +- var_band and one float32 step outside, total at m_cap and
    m_cap + 1; wins land in w, outcomes in the score cache (fresh pairs:
    0 before), border is returned."""
    import jax.numpy as jnp
    from rattle_tpu.cluster import bulk as jbulk
    from rattle_tpu.ops import pallas_kernels
    from rattle_tpu_torch.ops import kernels
    rng = np.random.default_rng(8)
    n, n_rows, n_cols, m_cap = 60, 24, 30, 128
    tv, band = np.float32(25.0), np.float32(0.5)
    flat = rng.permutation(n_rows * n_cols)[:500]
    rows, cols = flat // n_cols, flat % n_cols
    b = len(rows)
    row_ids = rng.permutation(n)[:n_rows]
    col_ids = rng.permutation(n)[:n_cols]
    edges = np.array([tv - band, tv + band], np.float32)
    var = rng.choice(np.concatenate([
        edges, np.nextafter(edges, [-np.inf, np.inf]).astype(np.float32),
        np.float32([0, 10, 24.9, 30, np.inf, np.nan])]), b).astype(np.float32)
    bases = rng.integers(0, 90, b).astype(np.int32)
    total = rng.choice([5, m_cap - 1, m_cap, m_cap + 1], b).astype(np.int32)
    lens = rng.integers(60, 250, n).astype(np.int32)
    sc_tab = rng.integers(0, 70, 251).astype(np.int32)
    w0 = rng.integers(0, 3, (n_rows, n_cols)).astype(np.int8)
    cache0 = rng.integers(0, 3, n * n).astype(np.uint8)
    cache0[row_ids[rows] * n + col_ids[cols]] = 0

    monkeypatch.setattr(jbulk, "merge_join_expand", lambda *a: (
        jnp.zeros((b, m_cap), jnp.int32), jnp.zeros((b, m_cap), jnp.int32),
        jnp.asarray(total)))
    monkeypatch.setattr(pallas_kernels, "lis_filter_pallas",
                        lambda *a, **k: (jnp.asarray(bases), None, None,
                                         jnp.asarray(var)))
    tabs = jnp.zeros((n, 8), jnp.uint32), jnp.zeros((n, 8), jnp.int32)
    t = torch.from_numpy
    for strand_val in (1, 2):
        w_ref, cache_ref, border_ref, _ = jbulk._score_body(
            jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            jnp.asarray(row_ids, jnp.int32), jnp.asarray(col_ids, jnp.int32),
            *tabs, jnp.zeros(n, jnp.int32), *tabs, jnp.asarray(lens),
            jnp.asarray(sc_tab), jnp.float32(tv), jnp.float32(band),
            strand_val, jnp.asarray(w0), jnp.asarray(cache0), m_cap, 10, 10,
            n, use_pallas=True)
        w, cache = t(w0.copy()), t(cache0.copy())
        border = kernels.score_decide(
            t(rows.astype(np.int64)), t(cols.astype(np.int64)),
            t(row_ids.astype(np.int64)), t(col_ids.astype(np.int64)),
            t(bases), t(var), t(total), t(lens), t(sc_tab),
            torch.tensor(tv), torch.tensor(band), strand_val, w, cache, n,
            m_cap)
        np.testing.assert_array_equal(border.numpy(), np.asarray(border_ref))
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
        np.testing.assert_array_equal(cache.numpy(), np.asarray(cache_ref))
        assert border.any() and (w.numpy() != w0).any()


@pytest.mark.parametrize("budget", ["one_pair", "37_pairs"])
def test_engine_range_launches_cut_by_byte_budget(monkeypatch, tmp_path,
                                                  budget):
    """A LAUNCH_BYTES so small that (class, tier) ranges are cut into several
    launches, mid-range, at the first M tier and at the next: every launch
    takes at least one pair, a range's launches take its pairs once, and
    clusters.out is the oracle's byte for byte and the JAX engine's
    clusters."""
    from rattle_tpu_torch.ops import kernels
    seqs = _families(10, n_fam=6, per=(8, 12), lo=260, hi=400, err=0.05)
    params, jparams = _params(is_rna=True)
    eng = BulkClusterEngine(seqs, params, device="cpu")
    assert len(seqs) >= 48 and len(eng.m_ladder) >= 2
    w0 = eng._cls_widths[0]
    monkeypatch.setattr(bulk, "LAUNCH_BYTES", 1 if budget == "one_pair" else
                        37 * kernels.score_pair_bytes(
                            kernels.join_expand, torch.zeros(1), w0, w0,
                            eng.m_ladder[0]))
    ranges = []            # (m_cap, pairs, [pairs of each launch])
    join, score_range = bulk.join_expand, eng._score_range

    def counted(rows, *a, **kw):
        ranges[-1][2].append(rows.shape[0])
        return join(rows, *a, **kw)

    def ranged(rows, cols, cls_i, m_cap, *a):
        ranges.append((m_cap, rows.shape[0], []))
        return score_range(rows, cols, cls_i, m_cap, *a)

    monkeypatch.setattr(bulk, "join_expand", counted)
    monkeypatch.setattr(eng, "_score_range", ranged)
    paths = {name: str(tmp_path / name) for name in ("engine", "oracle")}
    got = eng.cluster()
    write_clusters(got, paths["engine"])
    write_clusters(oracle.cluster_reads(seqs, params), paths["oracle"])
    with open(paths["engine"], "rb") as a, open(paths["oracle"], "rb") as b:
        assert a.read() == b.read()
    assert _sig(got) == _sig(JaxEngine(seqs, jparams).cluster())
    for _m, n, launches in ranges:
        assert sum(launches) == n and min(launches) >= 1
    cut = {m for m, _n, launches in ranges if len(launches) > 1}
    assert set(eng.m_ladder[:2]) <= cut


def test_launch_pairs_rule(monkeypatch):
    """``bulk.launch_pairs`` at ``kernels.score_pair_bytes``: never 0
    pairs, a budget of LAUNCH_BYTES, and on the card fewer than 2^31 pairs
    (the kernels' int pair index) whatever the range; an 800,000-pair range
    at M = 128 is one launch on the card, while the plain versions (on the
    CPU, or join_expand_plain on the card) keep their gathers and
    temporaries within the budget at a few thousand pairs."""
    from rattle_tpu_torch.ops import kernels
    for n in (1, 15, 16, 17, 1000, 10 ** 6, 3 * 10 ** 9):
        for pair_bytes in (1, 7, 1200, 10 ** 6, 10 ** 12):
            step = bulk.launch_pairs(n, pair_bytes)
            assert 1 <= step <= n
            if step > 1:
                assert step * pair_bytes <= bulk.LAUNCH_BYTES
    assert bulk.launch_pairs(10 ** 6, 10 ** 12) == 1
    rows = torch.zeros(1, dtype=torch.int64)
    plain = {}
    for wa, wb, m in ((1024, 1024, 128), (2048, 2048, 512),
                      (3072, 3072, 2048), (60000, 60000, 2048)):
        plain[wa, wb, m] = kernels.score_pair_bytes(kernels.join_expand, rows,
                                                    wa, wb, m)
        step = bulk.launch_pairs(10 ** 6, plain[wa, wb, m])
        gathered = 12 * (wa + wb) + 9 * m          # rows and lists alone
        assert plain[wa, wb, m] >= gathered
        assert step * plain[wa, wb, m] <= bulk.LAUNCH_BYTES
        assert step >= 64 and step * gathered <= bulk.LAUNCH_BYTES
    # the card's rule, with rows that count as on the card
    monkeypatch.setattr(kernels, "_on_card", lambda t: True)
    card = kernels.score_pair_bytes(kernels.join_expand, rows, 2048, 2048,
                                    128)
    assert card < plain[1024, 1024, 128]
    assert bulk.launch_pairs(800_000, card) == 800_000
    least = kernels.score_pair_bytes(kernels.join_expand, rows, 1, 1, 1)
    assert bulk.launch_pairs(3 * 10 ** 9, least) < 2 ** 31
    for key, nbytes in plain.items():
        # the plain switch on the card sizes for the plain versions
        assert kernels.score_pair_bytes(kernels.join_expand_plain, rows,
                                        *key) == nbytes
