"""The port's common-k-mer join and variance vs the JAX joins, the oracle's
``common_kmers`` and the JAX ``_variance`` (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rattle_tpu.cluster import oracle
from rattle_tpu.ops.join_device import merge_join_expand, sorted_join_expand
from rattle_tpu.ops.similarity import _variance
from rattle_tpu_torch.ops.join_device import join_expand
from rattle_tpu_torch.ops.similarity import variance


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
