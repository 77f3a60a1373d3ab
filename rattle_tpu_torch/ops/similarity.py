"""Batched pair scoring on tensors; port of rattle_tpu/ops/similarity.py
with its names and outputs.

* ``bv_gate`` ............ the bitvector pre-gate (cluster.cpp:13-19):
                           common 6-mers from ``kernels.bv_common``, the
                           integer threshold tables of ops/gates.py
* ``pair_match_counts`` .. total common-k-mer matches of each pair
* ``score_pairs`` ........ the join expanded in (pos1, pos2) order and
                           scored by ``kernels.lis_filter`` (patience LIS,
                           anchor filter, f32 variance)
* ``variance`` ........... the f32 variance gate (utils.cpp:36-55)

The cluster engine does not call the first three (it runs the score path of
``ops/kernels.py``); they keep the JAX package's functions and serve its
tests' inputs.  Hashes are int64 (or any integer dtype holding the unsigned
32-bit values) and bitvectors the port's packed [N, 128] int32 words.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .join_device import match_runs

INT32_MAX = 2**31 - 1


def variance(dist_arr: torch.Tensor, n_dist: torch.Tensor) -> torch.Tensor:
    """Compensated two-pass sample variance in f32 of each row's first
    ``n_dist`` entries: [B, M] int32, [B] -> [B] float32.

    n == 0 -> 0.0 (passes), n == 1 -> +inf (the reference's 0/0 NaN fails
    ``< t_v`` just like +inf does)."""
    b, m = dist_arr.shape
    mask = torch.arange(m, device=dist_arr.device)[None, :] < n_dist[:, None]
    df = torch.where(mask, dist_arr, 0).to(torch.float32)
    nf = torch.clamp(n_dist, min=1).to(torch.float32)
    mean = df.sum(dim=1) / nf
    d = torch.where(mask, df - mean[:, None], 0.0)
    ss = (d * d).sum(dim=1)
    comp = d.sum(dim=1)
    denom = torch.clamp(n_dist - 1, min=1).to(torch.float32)
    v = (ss - comp * comp / nf) / denom
    v = torch.where(n_dist == 0, 0.0, v)
    return torch.where(n_dist == 1, float("inf"), v)


def pair_match_counts(hbp_a: torch.Tensor, nk_a: torch.Tensor,
                      hs_b: torch.Tensor, nk_b: torch.Tensor
                      ) -> torch.Tensor:
    """Total common-k-mer matches per pair (before any cap): [B] int32.
    ``hbp_a`` [B, K] position-ordered hashes, ``hs_b`` [B, K'] sorted."""
    cnt = match_runs(hs_b.to(torch.int64), nk_b, hbp_a.to(torch.int64),
                     nk_a)[1]
    return cnt.sum(dim=1).to(torch.int32)


def _expand_matches(hbp_a, nk_a, hs_b, ps_b, nk_b, m_cap: int):
    """Up to ``m_cap`` (pos1, pos2) matches per pair in (pos1, pos2) order:
    read A is scanned in position order and read B's runs are
    position-ascending within an equal hash.  Returns (p1 [B, M] int32, p2
    [B, M] int32 padded with 0 and INT32_MAX, total [B] int32)."""
    b, k = hbp_a.shape
    dev = hbp_a.device
    lo, cnt = match_runs(hs_b.to(torch.int64), nk_b, hbp_a.to(torch.int64),
                         nk_a)
    offsets = torch.cumsum(cnt, dim=1)                        # inclusive
    total = offsets[:, -1]
    slot = torch.arange(m_cap, device=dev)[None, :].expand(b, m_cap)
    t = torch.searchsorted(offsets, slot.contiguous(), side="right")
    t = t.clamp(0, k - 1)
    prev = torch.where(t > 0, torch.gather(offsets, 1, (t - 1).clamp(min=0)),
                       0)
    idx_b = torch.gather(lo, 1, t) + slot - prev
    p2 = torch.gather(ps_b.to(torch.int64), 1,
                      idx_b.clamp(0, ps_b.shape[1] - 1))
    valid = slot < torch.clamp(total, max=m_cap)[:, None]
    p1 = torch.where(valid, t, 0).to(torch.int32)
    p2 = torch.where(valid, p2, INT32_MAX).to(torch.int32)
    return p1, p2, total.to(torch.int32)


def score_pairs(hbp_a: torch.Tensor, nk_a: torch.Tensor, hs_b: torch.Tensor,
                ps_b: torch.Tensor, nk_b: torch.Tensor, m_cap: int,
                kmer_size: int, hc_max_dist: int = 10
                ) -> Tuple[torch.Tensor, ...]:
    """Full join + LIS scoring of B pairs: (bases, hc_bases, var, n_dist,
    total_matches), each [B] (var float32, the rest int32).  Pairs with
    total_matches > m_cap must be rescored elsewhere (the LIS here sees only
    the first m_cap matches).  m_cap <= kernels.LIS_MAX_M."""
    from . import kernels  # kernels imports variance from here
    p1, p2, total = _expand_matches(hbp_a, nk_a, hs_b, ps_b, nk_b, m_cap)
    valid = torch.arange(m_cap, device=p1.device)[None, :] \
        < torch.clamp(total, max=m_cap)[:, None]
    bases, hc, n_dist, var = kernels.lis_filter(
        p1, p2, valid, kmer_size, hc_max_dist)
    return bases, hc, var, n_dist, total


def bv_gate(bvp_pool: torch.Tensor, bvc_pool: torch.Tensor,
            bvp_seeds: torch.Tensor, bvc_seeds: torch.Tensor,
            min_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitvector pre-gate: ([P, S] pass mask, [P, S] int32 popcount of
    AND).  ``bvp_*`` [N, 128] int32 packed words, ``bvc_*`` [N] distinct
    6-mer counts; ``min_table`` [4097] int32 encodes the threshold exactly
    (ops/gates.py); an all-zero table means threshold 0 (always pass,
    cluster.cpp:19's bypass)."""
    from . import kernels  # kernels imports variance from here
    common = kernels.bv_common(bvp_pool.contiguous(), bvp_seeds.contiguous())
    mmax = torch.maximum(bvc_pool[:, None], bvc_seeds[None, :]).long()
    return common >= min_table[mmax], common
