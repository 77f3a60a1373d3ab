"""``cluster``'s decision wave in the port against the JAX package on the
CPU: the gate (``kernels.gate_block_plain``, the plain version of the
gate_block kernel) against JAX's jitted ``gate_class_block``, the port's
``tier_partition`` against JAX's, and the engine's device->host reads
against its rule (at most two a strand and one a wave outside the rare
paths) with its clusters equal to the oracle's.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py phase 2b."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rattle_tpu.cluster import bulk as jbulk
from rattle_tpu_torch.cluster import bulk, oracle
from rattle_tpu_torch.cluster.bulk import BulkClusterEngine
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops import gates, kernels
from tests.conftest import make_read, mutate

# the plain versions are many small torch ops; the run has several workers
torch.set_num_threads(1)

N_READS = 160
BOUNDS = np.array([1024, 2048, 4096], np.int32)     # four K classes


def _planes(rng, n, n_fam=8, density=0.3):
    """[n, 4096] uint8 6-mer planes of n reads from n_fam families: each a
    family's plane thinned and salted, so that members pass the gate."""
    base = rng.random((n_fam, 4096)) < density
    fam = rng.integers(0, n_fam, n)
    keep = rng.random((n, 4096)) < 0.8
    salt = rng.random((n, 4096)) < 0.05
    return ((base[fam] & keep) | salt).astype(np.uint8)


def _pack(plane):
    """[n, 4096] 0/1 -> [n, 128] int32 words (bit h at word h >> 5, bit
    h & 31: ops/sketch.py's order)."""
    bits = plane.reshape(plane.shape[0], 128, 32).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return words.astype(np.uint32).view(np.int32)


def _gate_inputs(case):
    """One gate's inputs, numpy, from one seed: rows x cols of N_READS reads
    (global ids), their planes (the columns' from a second set for the
    reverse strand), orders, groups, the threshold table, the score cache
    (or None), w, the strand value and nk."""
    rng = np.random.default_rng(13)
    fwd = _planes(rng, N_READS)
    # the reverse strand's planes: the forward ones thinned again
    rev = fwd & (rng.random(fwd.shape) < 0.9).astype(np.uint8)
    nk = rng.integers(200, 6000, N_READS).astype(np.int32)
    ids = rng.permutation(N_READS)
    if case == "sweep":
        row_ids, col_ids = ids[:30], ids[30:]
    else:
        row_ids = col_ids = ids[:96]
    a, c = len(row_ids), len(col_ids)
    if case == "sweep":
        order_r, order_c = np.zeros(a, np.int32), np.ones(c, np.int32)
    else:
        order_r, order_c = np.arange(a, dtype=np.int32), \
            np.arange(c, dtype=np.int32)
    groups = rng.integers(0, 4, N_READS).astype(np.int32) \
        if case == "groups" else np.zeros(N_READS, np.int32)
    tab = gates.min_numerator_table(4096, 0.4)
    if case == "nothing":
        tab = np.full(4097, 4097, np.int32)
    cache = None
    if case in ("cache", "reverse"):
        cache = rng.choice(np.array([0, 1, 2], np.uint8), N_READS ** 2,
                           p=[0.5, 0.25, 0.25])
    w = np.zeros((a, c), np.int8)
    if case == "reverse":
        w = rng.choice(np.array([0, 1, 2], np.int8), (a, c),
                       p=[0.9, 0.05, 0.05])
    col_planes = rev if case == "reverse" else fwd
    return dict(rows_p=fwd[row_ids], cols_p=col_planes[col_ids],
                bvc_r=fwd[row_ids].sum(1, dtype=np.int32),
                bvc_c=fwd[col_ids].sum(1, dtype=np.int32),
                order_r=order_r, order_c=order_c, group_r=groups[row_ids],
                group_c=groups[col_ids], tab=tab, cache=cache,
                row_ids=row_ids, col_ids=col_ids, w=w,
                strand_val=1 if case == "reverse" else 2, nk=nk)


def _jax_gate(x):
    """JAX's gate_class_block on the inputs: (w, rows, cols, class
    counts), the pairs decoded from rc_flat by the columns' count."""
    a, c = x["w"].shape
    budget = 1 << max(10, (a * c - 1).bit_length())
    cache = x["cache"]
    n_pad = N_READS
    if cache is None:       # the JAX engine's cache-free form
        cache, n_pad = np.zeros(1, np.uint8), 1
    w, rc, _total, counts = jbulk.gate_class_block(
        jnp.asarray(x["rows_p"]), jnp.asarray(x["bvc_r"]),
        jnp.asarray(x["order_r"]), jnp.asarray(x["group_r"]), jnp.int32(a),
        jnp.asarray(x["cols_p"]), jnp.asarray(x["bvc_c"]),
        jnp.asarray(x["order_c"]), jnp.asarray(x["group_c"]), jnp.int32(c),
        jnp.asarray(x["tab"]), jnp.asarray(cache),
        jnp.asarray(x["row_ids"].astype(np.int32)),
        jnp.asarray(x["col_ids"].astype(np.int32)), jnp.asarray(x["w"]),
        jnp.int8(x["strand_val"]), jnp.asarray(x["nk"]), jnp.asarray(BOUNDS),
        budget=budget, n_pad=n_pad, n_classes=len(BOUNDS) + 1)
    counts = np.asarray(counts)
    rc = np.asarray(rc)[:int(counts.sum())]
    return np.asarray(w), rc // c, rc % c, counts


def _port_args(x):
    t = torch.from_numpy
    cache = None if x["cache"] is None else t(x["cache"].copy())
    return [t(_pack(x["rows_p"])), t(x["bvc_r"]), t(x["order_r"]),
            t(x["group_r"]), t(_pack(x["cols_p"])), t(x["bvc_c"]),
            t(x["order_c"]), t(x["group_c"]), t(x["tab"]), cache, N_READS,
            t(x["row_ids"].astype(np.int64)),
            t(x["col_ids"].astype(np.int64)), t(x["w"].copy()),
            x["strand_val"], t(x["nk"]), t(BOUNDS)]


@pytest.mark.parametrize("case", ["block", "sweep", "groups", "cache",
                                  "cache_off", "reverse", "nothing"])
def test_gate_block_plain_matches_jax_gate_class_block(case):
    """Fresh pairs (rows, cols, in class order and row-major within a
    class), class counts and the win matrix after the cache fold equal
    JAX's; the wrapper takes the plain version for CPU tensors, with no
    launch counted."""
    x = _gate_inputs(case)
    w_ref, rows_ref, cols_ref, counts_ref = _jax_gate(x)
    args = _port_args(x)
    rows, cols, counts, n_class = kernels.gate_block_plain(*args)
    np.testing.assert_array_equal(rows.numpy(), rows_ref)
    np.testing.assert_array_equal(cols.numpy(), cols_ref)
    np.testing.assert_array_equal(counts.numpy(), counts_ref)
    assert counts.dtype == torch.int32 and n_class == tuple(counts_ref)
    np.testing.assert_array_equal(args[13].numpy(), w_ref)
    if case == "nothing":
        assert len(rows_ref) == 0
    else:
        assert len(rows_ref) > 0
    if case in ("cache", "reverse"):
        assert (w_ref != x["w"]).any()      # the fold changed w
    if case == "block":
        assert (counts_ref > 0).sum() >= 2  # more than one class
    before = kernels.gate_block.launches
    args = _port_args(x)
    got = kernels.gate_block(*args)
    assert kernels.gate_block.launches == before
    np.testing.assert_array_equal(got[0].numpy(), rows_ref)
    np.testing.assert_array_equal(args[13].numpy(), w_ref)


def test_gate_block_rejects_bad_inputs():
    x = _gate_inputs("block")
    args = _port_args(x)
    bad = list(args)
    bad[2] = bad[2].long()                  # order must be int32
    with pytest.raises(ValueError, match="order_rows"):
        kernels.gate_block(*bad)
    bad = list(args)
    bad[16] = torch.arange(4, dtype=torch.int32)    # five classes
    with pytest.raises(ValueError, match="classes"):
        kernels.gate_block(*bad)
    bad = list(args)
    bad[9] = torch.zeros(10, dtype=torch.uint8)     # cache too small
    with pytest.raises(ValueError, match="cache"):
        kernels.gate_block(*bad)


def test_tier_partition_matches_jax():
    """The port's tier_partition against JAX's: the (class, tier, count)
    order of the pairs whose tier is not 0, and the [classes, tiers + 1]
    count matrix."""
    rng = np.random.default_rng(21)
    n_cls, m_caps, k = len(BOUNDS) + 1, (128, 512, 2048), 13
    a, c, n = 40, 50, 700
    flat = np.sort(rng.permutation(a * c)[:n])
    rows, cols = flat // c, flat % c
    row_ids = rng.permutation(N_READS)[:a]
    col_ids = rng.permutation(N_READS)[:c]
    nk = rng.integers(200, 6000, N_READS).astype(np.int32)
    lens = (nk + k).astype(np.int32)
    pair_nk = np.maximum(nk[row_ids[rows]], nk[col_ids[cols]])
    cls = (pair_nk[:, None] > BOUNDS[None, :]).sum(1)
    by_cls = np.argsort(cls, kind="stable")     # the gate's order
    rows, cols, cls = rows[by_cls], cols[by_cls], cls[by_cls]
    cnt = rng.choice(np.concatenate([np.arange(0, 40), np.arange(120, 140),
                                     np.arange(500, 530),
                                     np.arange(2040, 2060), [3000, 5000]]),
                     n).astype(np.int32)
    sc_tab = gates.min_numerator_table(int(lens.max()), 0.2)
    budget, pad = 1024, jbulk.CH_PAD
    rc_flat = np.full(budget + pad, -1, np.int32)
    rc_flat[:n] = rows * c + cols
    cnt_flat = np.zeros(budget + pad, np.int32)
    cnt_flat[:n] = cnt
    score_rc, counts_ref = jbulk.tier_partition(
        jnp.asarray(rc_flat), jnp.asarray(cnt_flat), jnp.int32(c),
        jnp.asarray(row_ids.astype(np.int32)),
        jnp.asarray(col_ids.astype(np.int32)), jnp.asarray(nk),
        jnp.asarray(lens), jnp.asarray(sc_tab), jnp.asarray(BOUNDS),
        budget=budget, n_classes=n_cls, m_caps=m_caps, kmer_size=k)
    score_rc = np.asarray(score_rc)[:n]
    t = torch.from_numpy
    lens_min = np.minimum(lens[row_ids[rows]], lens[col_ids[cols]])
    order, counts = bulk.tier_partition(
        t(cnt), t(cls.astype(np.int64)), t(lens_min), t(sc_tab), m_caps, k,
        n_cls)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_ref))
    assert counts.dtype == torch.int32
    order = order.numpy()
    got = (rows * c + cols)[order]
    keep = score_rc >= 0
    np.testing.assert_array_equal(got[keep], score_rc[keep])
    # the slots JAX drops are exactly the tier-0 ones (decided or rejected)
    assert (~keep).sum() == np.asarray(counts_ref)[:, 0].sum()
    assert keep.sum() > 0 and (np.asarray(counts_ref)[:, 1:] > 0).sum() >= 3


def _families(seed, n_fam=6, per=(8, 12), lo=200, hi=380, err=0.1):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        ref = make_read(rng, int(rng.integers(lo, hi)))
        for _ in range(int(rng.integers(*per))):
            seqs.append(mutate(rng, ref, err))
    seqs.sort(key=lambda s: -len(s))
    return seqs


@pytest.mark.parametrize("case", ["rna", "cdna", "all_borderline",
                                  "overflow_tier"])
def test_engine_host_reads_keep_the_rule(case):
    """At least ORACLE_CUTOVER reads, blocks of 16 (so sweeps run): every
    wave reads the card at most twice a strand and once more at its end;
    the rare paths (forced here as in test_torch_engine.py's rare-path
    tests) read only apart, and the clusters are the oracle's."""
    seqs = _families(31 if case != "overflow_tier" else 32,
                     err=0.04 if case == "overflow_tier" else 0.1)
    assert len(seqs) >= bulk.ORACLE_CUTOVER
    params = ClusterParams(is_rna=case != "cdna")
    eng = BulkClusterEngine(seqs, params, device="cpu")
    eng.k_block = 16
    if case == "all_borderline":
        eng.var_band = np.float32(1e12)
    if case == "overflow_tier":
        eng.m_ladder = (eng.m_ladder[0],)
    got = eng.cluster()
    strands = 1 if params.is_rna else 2
    assert eng.waves > 0
    assert eng.wave_reads_max <= 1 + 2 * strands
    assert eng.host_reads <= eng.waves * (1 + 2 * strands)
    if case in ("all_borderline", "overflow_tier"):
        assert eng.n_oracle_fallbacks > 0 and eng.rare_reads > 0
    want = oracle.cluster_reads(seqs, params)
    assert [(c_.main_seq.seq_id, c_.main_seq.rev,
             [(s.seq_id, s.rev) for s in c_.seqs]) for c_ in got] == \
        [(c_.main_seq.seq_id, c_.main_seq.rev,
          [(s.seq_id, s.rev) for s in c_.seqs]) for c_ in want]
    # on the CPU no section has a device time
    assert not any(k.endswith("_dev") for k in eng.phase_times)
