"""Select-based LIS scoring scans: the plain PyTorch twin of the LIS kernel.

Port of rattle_tpu/ops/lis_select.py.  Each of the three scans
(similarity.cpp:4-97) is a Python loop over the M match slots, and every
per-lane binary search or point update is one wide compare/select over the
whole [B, M + 1] row, exactly as the JAX scans do it:

  level     = sum(tails < v)                  (one [B, M+1] compare + reduce)
  update    = where(col == level, v, tails)   (one [B, M+1] select)

It is O(M^2) work per pair and serves as the arithmetic reference for
``csrc/lis_filter.cu`` (CPU runs and on-card comparisons), never as the
card's main path.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def lis_build_select(p2: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Patience LIS (similarity.cpp:10-31).

    p2 [B, M] int32, valid [B, M] bool -> (p_pred [B, M], m_idx [B, M+1],
    l [B]), all int32."""
    b, m = p2.shape
    dev = p2.device
    cols1 = torch.arange(m + 1, dtype=torch.int32, device=dev)[None, :]
    tails = torch.full((b, m + 1), INT32_MAX, dtype=torch.int32, device=dev)
    tails[:, 0] = INT32_MIN
    m_idx = torch.zeros((b, m + 1), dtype=torch.int32, device=dev)
    p_pred = torch.zeros((b, m), dtype=torch.int32, device=dev)
    l = torch.zeros((b,), dtype=torch.int32, device=dev)
    for i in range(m):
        v = p2[:, i]
        ok = valid[:, i]
        # level 0 is -INF so the count is >= 1 for any v > INT32_MIN
        new_l = (tails < v[:, None]).sum(dim=1, dtype=torch.int32)
        pred = torch.where(cols1 == (new_l - 1)[:, None], m_idx, 0).sum(
            dim=1, dtype=torch.int32)
        p_pred[:, i] = torch.where(ok, pred, 0)
        upd = ok[:, None] & (cols1 == new_l[:, None])
        m_idx = torch.where(upd, i, m_idx)
        tails = torch.where(upd, v[:, None], tails)
        l = torch.where(ok, torch.maximum(l, new_l), l)
    return p_pred, m_idx, l


def lis_reconstruct_select(p_pred: torch.Tensor, m_idx: torch.Tensor,
                           l: torch.Tensor) -> torch.Tensor:
    """Predecessor walk (similarity.cpp:37-44): the LIS match indices laid
    into [B, M] slots in forward order."""
    b, m = p_pred.shape
    dev = p_pred.device
    cols1 = torch.arange(m + 1, dtype=torch.int32, device=dev)[None, :]
    colsm = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    k = torch.where(cols1 == l[:, None], m_idx, 0).sum(dim=1,
                                                        dtype=torch.int32)
    s_arr = torch.zeros((b, m), dtype=torch.int32, device=dev)
    for i in range(m):
        active = i < l
        w = (l - 1 - i)[:, None]
        s_arr = torch.where((colsm == w) & active[:, None], k[:, None], s_arr)
        k_next = torch.where(colsm == k[:, None], p_pred, 0).sum(
            dim=1, dtype=torch.int32)
        k = torch.where(active, k_next, k)
    return s_arr


def anchor_filter_select(a1: torch.Tensor, a2: torch.Tensor, l: torch.Tensor,
                         kmer_size: int, hc_max_dist: int):
    """Forward anchor filter (similarity.cpp:52-85).  Returns (bases, hc,
    kept [B] int32, dist_arr [B, M] int32)."""
    b, m = a1.shape
    dev = a1.device
    colsm = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    z = torch.zeros((b,), dtype=torch.int32, device=dev)
    lf, ls, prev_a2, bases, hc, kept = z, z, z, z, z, z
    dist_arr = torch.zeros((b, m), dtype=torch.int32, device=dev)
    for i in range(m):
        x1 = a1[:, i]
        x2 = a2[:, i]
        active = i < l
        first = kept == 0
        d1 = x1 - lf
        d2 = x2 - ls
        keep_cond = ((d1 < kmer_size) & (d2 < kmer_size)) | \
            ((d1 >= kmer_size) & (d2 >= kmer_size))
        keep = active & (first | keep_cond)
        ex = kmer_size - (x2 - prev_a2)
        add = kmer_size - torch.clamp(ex, min=0)
        dist = (x2 - ls) - (x1 - lf)
        inc = torch.where(first, kmer_size, add)
        bases = bases + torch.where(keep, inc, 0)
        hc_inc = torch.where(first, kmer_size,
                             torch.where(dist < hc_max_dist, add, 0))
        hc = hc + torch.where(keep, hc_inc, 0)
        rec = keep & ~first
        dist_arr = torch.where((colsm == (kept - 1)[:, None]) & rec[:, None],
                               dist[:, None], dist_arr)
        kept = kept + keep.to(torch.int32)
        lf = torch.where(keep, x1, lf)
        ls = torch.where(keep, x2, ls)
        prev_a2 = torch.where(active, x2, prev_a2)
    return bases, hc, kept, dist_arr
