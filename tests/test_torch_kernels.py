"""The two kernels' plain versions vs the JAX Pallas kernels (interpret mode)
and their XLA twins, on the CPU, and the argument checks of the score
path's wrappers (join_expand, score_decide, greedy_owner; their plain
versions are held against the JAX package in test_torch_join.py and
test_torch_engine.py).  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py (this suite needs jax, which
the card's machine does not have)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rattle_tpu.ops.lis_select import (anchor_filter_select, lis_build_select,
                                       lis_reconstruct_select)
from rattle_tpu.ops.pallas_kernels import (POOL_TILE, bv_common_matmul,
                                           lis_filter_pallas)
from rattle_tpu.ops.similarity import _variance
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.utils.synth import LIS_CASES, lis_cases

# the plain versions are many small torch ops; the run has several workers
torch.set_num_threads(1)


def _popcount_ref(pool, seed):
    anded = pool[:, None, :] & seed[None, :, :]
    return np.bitwise_count(anded).sum(axis=2, dtype=np.int64)


def _words(rng, rows, density=1.0):
    w = rng.integers(0, 2**32, size=(rows, 128), dtype=np.uint32)
    return np.where(rng.random((rows, 128)) < density, w, 0).astype(np.uint32)


@pytest.mark.parametrize("p,s,density", [(POOL_TILE, 64, 0.3),
                                         (2 * POOL_TILE, 8, 1.0)])
def test_bv_common_plain_matches_pallas(p, s, density):
    rng = np.random.default_rng(p + s)
    pool = _words(rng, p, density)
    seed = _words(rng, s)
    pool[-3:] = 0  # zero padding rows are inert
    ref = np.asarray(bv_common_matmul(jnp.asarray(pool), jnp.asarray(seed),
                                      interpret=True))
    before = kernels.bv_common.launches
    got = kernels.bv_common(torch.from_numpy(pool.view(np.int32)),
                            torch.from_numpy(seed.view(np.int32)))
    assert kernels.bv_common.launches == before  # CPU: plain, no launch
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), _popcount_ref(pool, seed))
    assert (got.numpy()[-3:] == 0).all()


def test_bv_common_ragged_shapes():
    """No padding contract on the port: any row counts.  Sizes off the CUDA
    kernel's 128 x 128 block tile on either side (chip_smoke.py holds the
    kernel to the same) against the Pallas kernel, whose operands are padded
    with inert zero rows to its tiling."""
    rng = np.random.default_rng(9)
    pool, seed = _words(rng, 37), _words(rng, 5, 0.5)
    got = kernels.bv_common(torch.from_numpy(pool.view(np.int32)),
                            torch.from_numpy(seed.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), _popcount_ref(pool, seed))
    for p, s in ((1, 1), (15, 129), (129, 15), (200, 131)):
        pool, seed = _words(rng, p, 0.6), _words(rng, s)
        pool_pad = np.zeros((-(-p // POOL_TILE) * POOL_TILE, 128), np.uint32)
        seed_pad = np.zeros((-(-s // 8) * 8, 128), np.uint32)
        pool_pad[:p], seed_pad[:s] = pool, seed
        ref = np.asarray(bv_common_matmul(jnp.asarray(pool_pad),
                                          jnp.asarray(seed_pad),
                                          interpret=True))[:p, :s]
        got = kernels.bv_common(torch.from_numpy(pool.view(np.int32)),
                                torch.from_numpy(seed.view(np.int32)))
        assert got.shape == (p, s)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), _popcount_ref(pool, seed))


def _match_lists(rng, b, m):
    """Join-shaped input: matches sorted by (p1, p2), p2 INT32_MAX pads."""
    n_valid = rng.integers(0, m + 1, size=b).astype(np.int32)
    p1 = rng.integers(0, 300, size=(b, m))
    # a colinear majority (long LIS) plus noise, as real pairs have
    p2 = np.where(rng.random((b, m)) < 0.7, p1 + rng.integers(-3, 4, (b, m)),
                  rng.integers(0, 300, (b, m)))
    order = np.lexsort((p2, p1), axis=1)
    p1 = np.take_along_axis(p1, order, axis=1).astype(np.int32)
    p2 = np.take_along_axis(p2, order, axis=1).astype(np.int32)
    valid = np.arange(m)[None, :] < n_valid[:, None]
    p1 = np.where(valid, p1, 0).astype(np.int32)
    p2 = np.where(valid, p2, 2**31 - 1).astype(np.int32)
    return p1, p2, valid, n_valid


def _select_twin(p1, p2, valid, k, hc):
    """The JAX select scans + _variance (rattle_tpu's non-Pallas path)."""
    p_pred, m_idx, l = lis_build_select(p2, valid)
    s = lis_reconstruct_select(p_pred, m_idx, l)
    a1 = jnp.take_along_axis(p1, s, axis=1)
    a2 = jnp.take_along_axis(p2, s, axis=1)
    bases, hcb, kept, dist = anchor_filter_select(a1, a2, l, k, hc)
    n = jnp.maximum(kept - 1, 0)
    return [np.asarray(x) for x in (bases, hcb, n, _variance(dist, n))]


def _assert_lis_equal(got, ref):
    for g, r in zip(got[:3], ref[:3]):  # bases, hc, n_dist: exact
        np.testing.assert_array_equal(g, r)
    # var: f32 with another reduction order (tests/test_lis_pallas.py:45)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-5)


def _lis_adversarial(name):
    """One batch of utils/synth.lis_cases against the Pallas kernel with its
    bound and against the select twin on the lists cut at the bound."""
    _n, p1, p2, valid, bound = dict(
        (c[0], c) for c in lis_cases(16, 64))[name]
    k, hc = 10, 10
    cut = valid & (np.arange(p1.shape[1])[None, :] < bound)
    pallas = [np.asarray(x) for x in lis_filter_pallas(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), k, hc,
        interpret=True, bound=jnp.int32(bound))]
    twin = _select_twin(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(cut),
                        k, hc)
    got = [x.numpy() for x in kernels.lis_filter(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        k, hc, bound=torch.tensor([bound], dtype=torch.int32))]
    _assert_lis_equal(got, pallas)
    _assert_lis_equal(got, twin)
    np.testing.assert_array_equal(np.isinf(got[3]), np.isinf(pallas[3]))
    return got


@pytest.mark.parametrize("use_bound", [False, True, *LIS_CASES])
def test_lis_plain_matches_pallas_and_select(use_bound):
    """False / True: join-shaped random lists, scanned to M or to the
    batch's largest count; a name: that adversarial batch of
    utils/synth.lis_cases (all-invalid rows, one or two matches, INT32_MIN
    p2, decreasing p2, tied runs, invalid holes, bound 0, a bound above
    every count)."""
    if not isinstance(use_bound, bool):
        got = _lis_adversarial(use_bound)
        if use_bound == "counts_1_2":   # var 0 (n_dist 0) and +inf (1)
            assert set(got[2].tolist()) == {0, 1}
            assert np.isinf(got[3]).any() and (got[3] == 0).any()
        elif use_bound in ("all_invalid", "bound_zero"):
            empty = got[0] == 0
            assert empty.any() and (got[3][empty] == 0).all()
        return
    rng = np.random.default_rng(11 + use_bound)
    b, m, k, hc = 16, 48, 10, 10
    for _trial in range(3):
        p1, p2, valid, n_valid = _match_lists(rng, b, m)
        bound = int(n_valid.max()) if use_bound else None
        j_bound = None if bound is None else jnp.int32(bound)
        t_bound = None if bound is None else torch.tensor([bound],
                                                          dtype=torch.int32)
        args = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
        pallas = [np.asarray(x) for x in lis_filter_pallas(
            *args, k, hc, interpret=True, bound=j_bound)]
        twin = _select_twin(*args, k, hc)
        before = kernels.lis_filter.launches
        got = [x.numpy() for x in kernels.lis_filter(
            torch.from_numpy(p1), torch.from_numpy(p2),
            torch.from_numpy(valid), k, hc, bound=t_bound)]
        assert kernels.lis_filter.launches == before
        _assert_lis_equal(got, pallas)
        _assert_lis_equal(got, twin)


def test_lis_bound_truncates_like_pallas():
    """A bound below some pairs' match counts truncates every scan there,
    in the plain version exactly as in the Pallas kernel."""
    rng = np.random.default_rng(21)
    p1, p2, valid, _ = _match_lists(rng, 16, 64)
    args = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    pallas = [np.asarray(x) for x in lis_filter_pallas(
        *args, 10, 10, interpret=True, bound=jnp.int32(20))]
    got = [x.numpy() for x in kernels.lis_filter(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        10, 10, bound=torch.tensor(20, dtype=torch.int32))]
    _assert_lis_equal(got, pallas)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((4, 128), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.bv_common(x, x)
    p = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.lis_filter(p, p, torch.zeros((4, 8), dtype=torch.int8), 10)
    with pytest.raises(ValueError):
        kernels.lis_filter(p.T, p.T, torch.zeros((8, 4), dtype=torch.bool), 10)
    long = torch.zeros((1, kernels.LIS_MAX_M + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        kernels.lis_filter(long, long, long.bool(), 10)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises with a clear message; it never falls
    back.  The library name follows the source hash, so an edited source
    builds anew."""
    from rattle_tpu_torch import _ext
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_ext, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.build(["bv_common"])
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_ext, "CSRC", str(src))
    (src / "k.cu").write_text("// one\n")
    first = _ext.library_path("k")[1]
    (src / "k.cu").write_text("// two\n")
    assert _ext.library_path("k")[1] != first


def _score_path_args(dev="cpu"):
    """Small valid arguments of join_expand (up to m_cap) and score_decide."""
    i64 = lambda n: torch.zeros(n, dtype=torch.int64, device=dev)  # noqa: E731
    hs = torch.zeros((4, 16), dtype=torch.int64, device=dev)
    ps = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    nk = torch.ones(4, dtype=torch.int32, device=dev)
    join = [i64(3), i64(3), i64(4), i64(4), i64(4), i64(4), hs, ps, hs, ps,
            nk]
    i32 = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)  # noqa: E731
    f32 = lambda: torch.tensor(1.0, device=dev)  # noqa: E731
    decide = [i64(3), i64(3), i64(4), i64(4), i32(3),
              torch.zeros(3, device=dev), i32(3), i32(4), i32(8), f32(),
              f32(), 2, torch.zeros((4, 4), dtype=torch.int8, device=dev),
              torch.zeros(16, dtype=torch.uint8, device=dev), 4, 8]
    return join, decide


def test_score_path_wrappers_reject_bad_inputs():
    """join_expand, score_decide and greedy_owner check types, shapes and
    strides on every device; the good arguments run (the plain versions)."""
    join, decide = _score_path_args()
    kernels.join_expand(*join, 8)
    kernels.score_decide(*decide)
    kernels.greedy_owner(torch.zeros((5, 5), dtype=torch.int8), 5)

    def bad_join(i, value, m_cap=8, **kw):
        args = list(join)
        if i is not None:
            args[i] = value
        with pytest.raises(ValueError):
            kernels.join_expand(*args, m_cap, **kw)

    bad_join(0, join[0].int())                       # rows int32
    bad_join(1, join[1][:2])                         # cols shorter
    bad_join(4, join[4][:3])                         # row_tab != row_ids
    bad_join(6, join[6].int())                       # hashes int32
    bad_join(7, join[7][:, :8])                      # ps_a narrower
    bad_join(8, torch.zeros((16, 4), dtype=torch.int64).T)  # column stride
    bad_join(None, None, m_cap=0)
    bad_join(None, None, m_cap=kernels.LIS_MAX_M + 1)
    bad_join(None, None, total=torch.zeros(2, dtype=torch.int32))
    bad_join(None, None, bound=torch.zeros(2, dtype=torch.int32))

    def bad_decide(i, value, **kw):
        args = list(decide)
        if i is not None:
            args[i] = value
        with pytest.raises(ValueError):
            kernels.score_decide(*args, **kw)

    bad_decide(5, decide[5].double())                # var float64
    bad_decide(6, decide[6][:2])                     # total shorter
    bad_decide(9, torch.tensor([1.0, 2.0]))          # t_v not a scalar
    bad_decide(12, decide[12].int())                 # w int32
    bad_decide(13, decide[13][:15])                  # cache too small
    bad_decide(None, None, border=torch.zeros(3, dtype=torch.uint8))

    for w, n_valid in ((torch.zeros((4, 5), dtype=torch.int8), 4),
                       (torch.zeros((5, 5), dtype=torch.int32), 5),
                       (torch.zeros((5, 5), dtype=torch.int8), 6),
                       (torch.zeros((kernels.GREEDY_MAX_K + 1,) * 2,
                                    dtype=torch.int8), 1)):
        with pytest.raises(ValueError):
            kernels.greedy_owner(w, n_valid)

    # neither the CPU nor the card: raises, never falls back
    join_m, decide_m = _score_path_args("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.join_expand(*join_m, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.score_decide(*decide_m)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.greedy_owner(torch.zeros((5, 5), dtype=torch.int8,
                                         device="meta"), 5)


@pytest.mark.parametrize("name", ["join_expand", "score_decide",
                                  "greedy_owner"])
def test_score_path_kernel_load_needs_nvcc(monkeypatch, tmp_path, name):
    """Each score-path kernel is a registered library built from its own
    source at first use; without nvcc loading it raises (what a wrapper
    does on a CUDA tensor when the library cannot be built)."""
    from rattle_tpu_torch import _ext
    assert name in _ext.KERNELS and name in _ext._SIGNATURES
    assert os.path.exists(_ext.library_path(name)[0])
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_ext, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_ext, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.load(name)
