"""The rest of the port's ops/similarity.py (``bv_gate``,
``pair_match_counts``, ``score_pairs``) and ops/join_device.py's
``join_counts`` vs the JAX functions, on the inputs of
tests/test_similarity_kernel.py and tests/test_join_device.py.

Integers exactly; ``var`` (f32 on both sides, summed in another order) to
rtol 1e-5 with the same infinities.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rattle_tpu.ops import gates as jax_gates
from rattle_tpu.ops import join_device as jax_join
from rattle_tpu.ops import similarity as jax_sim
from rattle_tpu.ops.sketch import build_sketch_tables
from rattle_tpu_torch.ops import join_device, similarity
from tests.test_join_device import _tables
from tests.test_similarity_kernel import _random_related_seqs

torch.set_num_threads(1)


def _t(x, dtype=np.int64):
    return torch.from_numpy(np.ascontiguousarray(x).astype(dtype))


def _words(bvp):
    """uint32 bitvector words as the port's int32 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(bvp).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_pairs_matches_jax(seed):
    k, m_cap = 10, 256
    rng = np.random.default_rng(seed)
    seqs = _random_related_seqs(rng, 16)
    t = build_sketch_tables(seqs, k, False)
    a, b = np.arange(0, 16, 2), np.arange(1, 16, 2)
    ins = (t.hbp[a], t.nk[a], t.hs[b], t.ps[b], t.nk[b])
    want = [np.asarray(x) for x in jax_sim.score_pairs(
        *[jnp.asarray(x) for x in ins], m_cap, k, 10)]
    got = [x.numpy() for x in similarity.score_pairs(
        _t(ins[0]), _t(ins[1], np.int32), _t(ins[2]), _t(ins[3], np.int32),
        _t(ins[4], np.int32), m_cap, k, 10)]
    bases, hc, var, n_dist, total = got
    np.testing.assert_array_equal(total, want[4])
    fit = want[4] <= m_cap
    assert fit.any()
    for g, w in ((bases, want[0]), (hc, want[1]), (n_dist, want[3])):
        np.testing.assert_array_equal(g[fit], w[fit])
    np.testing.assert_array_equal(np.isinf(var[fit]), np.isinf(want[2][fit]))
    finite = fit & ~np.isinf(want[2])
    np.testing.assert_allclose(var[finite], want[2][finite], rtol=1e-5)


def test_score_pairs_caps_overflowing_pairs_like_jax():
    """m_cap below the match counts: the first m_cap matches in (pos1,
    pos2) order are scored on both sides."""
    k, m_cap = 10, 16
    rng = np.random.default_rng(5)
    seqs = _random_related_seqs(rng, 8)
    t = build_sketch_tables(seqs, k, False)
    a, b = np.arange(0, 8, 2), np.arange(1, 8, 2)
    ins = (t.hbp[a], t.nk[a], t.hs[b], t.ps[b], t.nk[b])
    want = [np.asarray(x) for x in jax_sim.score_pairs(
        *[jnp.asarray(x) for x in ins], m_cap, k, 10)]
    got = [x.numpy() for x in similarity.score_pairs(
        _t(ins[0]), _t(ins[1], np.int32), _t(ins[2]), _t(ins[3], np.int32),
        _t(ins[4], np.int32), m_cap, k, 10)]
    assert (want[4] > m_cap).any()
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_match_counts_matches_jax(seed):
    rng = np.random.default_rng(seed)
    seqs = _random_related_seqs(rng, 8)
    t = build_sketch_tables(seqs, 10, False)
    ins = (t.hbp[:4], t.nk[:4], t.hs[4:], t.nk[4:])
    want = np.asarray(jax_sim.pair_match_counts(
        *[jnp.asarray(x) for x in ins]))
    got = similarity.pair_match_counts(_t(ins[0]), _t(ins[1], np.int32),
                                       _t(ins[2]), _t(ins[3], np.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thr", [0.0, 0.35])
def test_bv_gate_matches_jax(thr):
    rng = np.random.default_rng(11)
    seqs = _random_related_seqs(rng, 12)
    t = build_sketch_tables(seqs, 10, False)
    tab = jax_gates.min_numerator_table(4096, thr)
    want = [np.asarray(x) for x in jax_sim.bv_gate(
        jnp.asarray(t.bvp), jnp.asarray(t.bvc), jnp.asarray(t.bvp[:4]),
        jnp.asarray(t.bvc[:4]), jnp.asarray(tab))]
    passed, common = similarity.bv_gate(
        _words(t.bvp), _t(t.bvc, np.int32), _words(t.bvp[:4]),
        _t(t.bvc[:4], np.int32), _t(tab, np.int32))
    np.testing.assert_array_equal(common.numpy(), want[1])
    np.testing.assert_array_equal(passed.numpy(), want[0])
    assert want[0].any() and (thr == 0.0) == want[0].all()


@pytest.mark.parametrize("widths", [(80, 80), (64, 128), (128, 48)],
                         ids=["equal", "a_narrower", "b_narrower"])
def test_join_counts_matches_jax(widths):
    rng = np.random.default_rng(1)
    b = 48
    _h, hs_a, _p, nk_a = _tables(rng, b, widths[0], hash_space=200)
    _h2, hs_b, _p2, nk_b = _tables(rng, b, widths[1], hash_space=200)
    want = np.asarray(jax_join.join_counts(
        jnp.asarray(hs_a), jnp.asarray(nk_a), jnp.asarray(hs_b),
        jnp.asarray(nk_b)))
    got = join_device.join_counts(_t(hs_a), _t(nk_a, np.int32), _t(hs_b),
                                  _t(nk_b, np.int32))
    assert got.dtype == torch.int32 and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
