"""The port's common-k-mer join and variance vs the JAX joins, the oracle's
``common_kmers`` and the JAX ``_variance`` (CPU); and the score path's
``kernels.join_expand`` (table rows read by id, the plain version on the
CPU) vs JAX's table gathers + join as ``_score_body`` composes them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rattle_tpu.cluster import oracle
from rattle_tpu.ops.join_device import merge_join_expand, sorted_join_expand
from rattle_tpu.ops.similarity import _variance
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.ops.join_device import join_expand
from rattle_tpu_torch.ops.similarity import variance
from rattle_tpu_torch.utils.synth import JOIN_CASES, RUN_HASH, join_cases

# the plain join is many small torch ops; the run has several workers
torch.set_num_threads(1)


def _tables(rng, b, w, hash_space, maxpos=3000):
    """Hash-sorted tables with duplicate hashes: (hs, ps, nk) numpy."""
    hs = np.sort(rng.integers(0, hash_space, (b, w)), axis=1).astype(np.uint32)
    ps = rng.integers(0, maxpos, (b, w)).astype(np.int32)
    nk = rng.integers(1, w + 1, (b,)).astype(np.int32)
    return hs, ps, nk


def _port(hs_a, ps_a, nk_a, hs_b, ps_b, nk_b, m_cap):
    t = lambda a, d: torch.from_numpy(np.asarray(a).astype(d))  # noqa: E731
    out = join_expand(t(hs_a, np.int64), t(ps_a, np.int32), t(nk_a, np.int32),
                      t(hs_b, np.int64), t(ps_b, np.int32), t(nk_b, np.int32),
                      m_cap)
    return [o.numpy() for o in out]


def _check_pairs(got, ref, m_cap):
    """Exact (p1, p2, total) where the pair fits m_cap; total only where it
    overflows (the contract)."""
    g1, g2, gt = got
    r1, r2, rt = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gt, rt)
    fits = rt <= m_cap
    assert fits.any() and (~fits).any()
    np.testing.assert_array_equal(g1[fits], r1[fits])
    np.testing.assert_array_equal(g2[fits], r2[fits])


@pytest.mark.parametrize("m_cap", [32, 128])
def test_join_matches_merge_join(m_cap):
    """k <= 15 route: equal power-of-two widths (bulk.py's class tables)."""
    rng = np.random.default_rng(m_cap)
    args = _tables(rng, 24, 256, 150) + _tables(rng, 24, 256, 150)
    got = _port(*args, m_cap)
    ref = merge_join_expand(*(jnp.asarray(a) for a in args), m_cap)
    _check_pairs(got, ref, m_cap)
    # pads: p1 zeroed, p2 INT32_MAX past each fitting pair's total
    for i in np.nonzero(got[2] <= m_cap)[0]:
        assert (got[0][i, got[2][i]:] == 0).all()
        assert (got[1][i, got[2][i]:] == 2**31 - 1).all()


def test_join_matches_sorted_join_mixed_widths_k16():
    """k = 16 route (hashes >= 2^31, unpacked sort) with the a- and b-side
    tables at different widths."""
    rng = np.random.default_rng(7)
    _, ps_a, nk_a = _tables(rng, 32, 64, 1)
    _, ps_b, nk_b = _tables(rng, 32, 128, 1)
    # few distinct hashes so pairs have matches, including ones >= 2^31 and
    # the PAD value itself on real entries
    pool = np.array([5, 2**31 + 3, 2**32 - 1, 77], np.uint32)
    hs_a = np.sort(rng.choice(pool, (32, 64)), axis=1).astype(np.uint32)
    hs_b = np.sort(rng.choice(pool, (32, 128)), axis=1).astype(np.uint32)
    args = (hs_a, ps_a, nk_a, hs_b, ps_b, nk_b)
    got = _port(*args, 256)
    ref = sorted_join_expand(*(jnp.asarray(a) for a in args), 256,
                             packed=False)
    _check_pairs(got, ref, 256)


def test_join_matches_oracle_common_kmers():
    rng = np.random.default_rng(3)
    args = _tables(rng, 16, 128, 60) + _tables(rng, 16, 128, 60)
    hs_a, ps_a, nk_a, hs_b, ps_b, nk_b = args
    m_cap = 512
    p1, p2, total = _port(*args, m_cap)
    for i in range(16):
        # the oracle takes the pair's real entries; positions need not be
        # unique for the (p1, p2) order to be well defined
        o1, o2 = oracle.common_kmers(hs_a[i, :nk_a[i]], ps_a[i, :nk_a[i]],
                                     hs_b[i, :nk_b[i]], ps_b[i, :nk_b[i]])
        assert total[i] == len(o1)
        if len(o1) <= m_cap:
            np.testing.assert_array_equal(p1[i, :len(o1)], o1)
            np.testing.assert_array_equal(p2[i, :len(o1)], o2)


def test_variance_matches_jax():
    rng = np.random.default_rng(5)
    b, m = 64, 96
    dist = rng.integers(-40, 40, (b, m)).astype(np.int32)
    n = rng.integers(0, m + 1, (b,)).astype(np.int32)
    n[:4] = [0, 1, 2, m]
    got = variance(torch.from_numpy(dist), torch.from_numpy(n)).numpy()
    ref = np.asarray(_variance(jnp.asarray(dist), jnp.asarray(n)))
    assert got.dtype == np.float32
    assert got[0] == 0.0 and np.isinf(got[1])
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# --------------------------------------------------------------------------
# kernels.join_expand: the score path's join, reading table rows by id
# --------------------------------------------------------------------------


def _side(rng, n_reads, width, full, hashes):
    """One side's sketch-like tables: [n_reads, full] int64 hashes sorted
    over each read's first nk <= width entries, co-sorted int32 positions,
    and the class table handed to the join, a slice [:, :width] of them."""
    hs = np.full((n_reads, full), 0xFFFFFFFF, np.int64)
    ps = np.zeros((n_reads, full), np.int32)
    nk = rng.integers(1, width + 1, n_reads).astype(np.int32)
    for i in range(n_reads):
        h = hashes(nk[i]).astype(np.int64)
        p = rng.permutation(4 * full)[:nk[i]].astype(np.int32)
        o = np.lexsort((p, h))
        hs[i, :nk[i]], ps[i, :nk[i]] = h[o], p[o]
    return hs, ps, nk


def _id_case(rng, n_reads, wa, wb, hashes, n_pairs, full=None):
    """A chunk as the engine hands it to ``kernels.join_expand``: global read
    ids (nk by id), tables whose rows are not the reads' ids (as on a mesh,
    where the row tables hold another rank's rows), pairs with repeated rows
    and columns, class tables that are slices of wider ones.  Returns (the
    wrapper's arguments, JAX's gathered inputs)."""
    full = full or max(wa, wb)
    hs, ps, nk = _side(rng, n_reads, max(wa, wb), full, hashes)
    tab_of = rng.permutation(n_reads)            # read id -> table row
    hs_t, ps_t = np.empty_like(hs), np.empty_like(ps)
    hs_t[tab_of], ps_t[tab_of] = hs, ps
    row_ids = rng.permutation(n_reads)[:n_reads - 3].astype(np.int64)
    col_ids = rng.permutation(n_reads)[:n_reads - 5].astype(np.int64)
    rows = rng.integers(0, len(row_ids), n_pairs).astype(np.int64)
    cols = rng.integers(0, len(col_ids), n_pairs).astype(np.int64)
    rows[:4] = rows[0]                           # repeats on both sides
    cols[4:8] = cols[4]
    hs_d, ps_d = torch.from_numpy(hs_t), torch.from_numpy(ps_t)
    t64 = torch.from_numpy
    args = (t64(rows), t64(cols), t64(row_ids), t64(col_ids),
            t64(tab_of[row_ids]), t64(tab_of[col_ids]), hs_d[:, :wa],
            ps_d[:, :wa], hs_d[:, :wb], ps_d[:, :wb], torch.from_numpy(nk))
    a, b = row_ids[rows], col_ids[cols]
    u32 = np.uint32
    ref_in = (hs[a, :wa].astype(u32), ps[a, :wa], np.minimum(nk[a], wa),
              hs[b, :wb].astype(u32), ps[b, :wb], np.minimum(nk[b], wb))
    return args, [jnp.asarray(x) for x in ref_in]


def _check_id_join(out, ref, m_cap):
    """p1/p2 exact where the pair fits, total always, valid and bound exact
    (the first min(total, m_cap) slots; the largest such count)."""
    p1, p2, total, valid, bound = (o.numpy() for o in out)
    _check_pairs((p1, p2, total), ref, m_cap)
    n_valid = np.minimum(total, m_cap)
    np.testing.assert_array_equal(
        valid, np.arange(m_cap)[None, :] < n_valid[:, None])
    assert bound.shape == (1,) and bound[0] == n_valid.max()


@pytest.mark.parametrize("m_cap", [32, 128])
def test_join_kernel_wrapper_matches_jax_gathers_merge_join(m_cap):
    """k <= 15: JAX's table gathers + ``merge_join_expand`` on the same
    pairs; the class table is a 128-wide slice of a 256-wide one."""
    rng = np.random.default_rng(100 + m_cap)
    args, ref_in = _id_case(rng, 40, 128, 128,
                            lambda n: rng.integers(0, 90, n), 48, full=256)
    out = kernels.join_expand(*args, m_cap)
    _check_id_join(out, merge_join_expand(*ref_in, m_cap), m_cap)


def test_join_kernel_wrapper_matches_jax_sorted_join_k16_mixed_widths():
    """k = 16: hashes >= 2^31 and the PAD value on real entries, a and b
    tables of different widths, against JAX's gathers +
    ``sorted_join_expand``.  A given ``total`` slice is written in place and
    a given ``bound`` raised from its earlier value."""
    rng = np.random.default_rng(16)
    pool = np.array([5, 2**31 + 3, 2**32 - 1, 77, 2**31], np.uint32)
    args, ref_in = _id_case(rng, 30, 64, 128,
                            lambda n: rng.choice(pool, n), 40)
    total = torch.full((45,), -7, dtype=torch.int32)
    bound = torch.tensor([3], dtype=torch.int32)
    out = kernels.join_expand(*args, 256, total=total[5:], bound=bound)
    assert out[2].data_ptr() == total[5:].data_ptr() and out[4] is bound
    assert (total[:5] == -7).all()
    _check_id_join(out, sorted_join_expand(*ref_in, 256, packed=False), 256)


@pytest.mark.parametrize("name", [n for n in JOIN_CASES
                                  if n != "wider_than_shared"])
def test_join_kernel_wrapper_adversarial_tables(name):
    """The adversarial tables chip_smoke.py holds the CUDA join to (one hash
    over whole rows, nk = 1, unequal widths, k = 16 hashes >= 2^31, a
    class-3 width of 6144), through the wrapper's plain version, against
    JAX's gathers + ``sorted_join_expand``."""
    (args, m_cap), = [(a, m) for n, a, m in join_cases(4, wide=False)
                      if n == name]
    out = kernels.join_expand(*(torch.from_numpy(a) for a in args), m_cap)
    rows, cols, row_ids, col_ids, row_tab, col_tab, hs_a, ps_a, hs_b, ps_b, \
        nk = args
    a_t, b_t = row_tab[rows], col_tab[cols]
    ref = sorted_join_expand(
        jnp.asarray(hs_a[a_t].astype(np.uint32)), jnp.asarray(ps_a[a_t]),
        jnp.asarray(np.minimum(nk[row_ids[rows]], hs_a.shape[1])),
        jnp.asarray(hs_b[b_t].astype(np.uint32)), jnp.asarray(ps_b[b_t]),
        jnp.asarray(np.minimum(nk[col_ids[cols]], hs_b.shape[1])), m_cap,
        packed=False)
    total = out[2].numpy()
    np.testing.assert_array_equal(total, np.asarray(ref[2]))
    fits = total <= m_cap
    for got, want in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(got.numpy()[fits],
                                      np.asarray(want)[fits])
    n_valid = np.minimum(total, m_cap)
    np.testing.assert_array_equal(
        out[3].numpy(), np.arange(m_cap)[None, :] < n_valid[:, None])
    assert int(out[4]) == n_valid.max()
    if name == "one_hash_rows":
        assert (total == 1024 * 1024).all()


def test_join_plain_straddling_runs_matches_jax():
    """``join_expand_plain`` on ``join_cases``' straddling_runs: one hash
    repeated over a run longer than a merge-path share (both rows of a pair
    split over 64 threads), in the b row or in the a row, against JAX's
    gathers + ``merge_join_expand``: p1 and p2 exact where the pair fits,
    total, valid and bound always (an overflowing pair keeps the first
    m_cap matches in b order on the card, which chip_smoke.py holds)."""
    (args, m_cap), = [(a, m) for n, a, m in join_cases(8, wide=False)
                      if n == "straddling_runs"]
    rows, cols, row_ids, col_ids, row_tab, col_tab, hs_a, ps_a, hs_b, ps_b, \
        nk = args
    a_t, b_t = row_tab[rows], col_tab[cols]
    run_a = (hs_a[a_t] == RUN_HASH).sum(axis=1)
    run_b = (hs_b[b_t] == RUN_HASH).sum(axis=1)
    share = -(-(hs_a.shape[1] + hs_b.shape[1]) // 64)
    out = kernels.join_expand_plain(*(torch.from_numpy(a) for a in args),
                                    m_cap)
    total = out[2].numpy()
    fits = total <= m_cap
    # a run spans two shares in a fitting pair, on each side, and one pair
    # overflows
    assert (fits & (run_b > share)).any() and (fits & (run_a > share)).any()
    assert (~fits).any()
    ref = merge_join_expand(
        jnp.asarray(hs_a[a_t].astype(np.uint32)), jnp.asarray(ps_a[a_t]),
        jnp.asarray(np.minimum(nk[row_ids[rows]], hs_a.shape[1])),
        jnp.asarray(hs_b[b_t].astype(np.uint32)), jnp.asarray(ps_b[b_t]),
        jnp.asarray(np.minimum(nk[col_ids[cols]], hs_b.shape[1])), m_cap)
    _check_id_join(out, ref, m_cap)
    assert (total >= run_a * run_b).all()
