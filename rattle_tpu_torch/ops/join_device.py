"""Common-k-mer join on the device (kmer.cpp:45-67); port of
rattle_tpu/ops/join_device.py (``merge_join_expand`` for k <= 15 and
``sorted_join_expand`` for k = 16, and ``join_counts``).

The JAX joins avoid gathers because TPUs have none (a bitonic merge plus
sort-based slot expansion).  A GPU gathers at rate, so this is a batched
binary-search join: for every b-side k-mer, ``torch.searchsorted`` finds its
run of equal hashes in the a-side table; a prefix sum of the run lengths
numbers the matches, and a second search maps each output slot back to its
b element.  Hashes are int64, so one join serves every k (no packed
``hash << 1 | side`` key and no k <= 15 limit).

Contract (join_device.py:14-17, 199-205): matches compacted to the front in
(pos1, pos2) order, p1 padded with 0 and p2 with INT32_MAX, and the TRUE
total returned.  On overflow (total > m_cap) only the total is contractual.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = 2**31 - 1
_A_PAD = 1 << 32        # above every real hash: a-side pads sort last
_B_PAD = (1 << 32) + 1  # matches no a-side entry, pad or real


def match_runs(hs_a: torch.Tensor, nk_a: torch.Tensor, hs_b: torch.Tensor,
               nk_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every b-side entry below nk_b (in any order), the start of its
    run of equal hashes in the first nk_a entries of the sorted a-side
    table and the run's length (0 from nk_b on)."""
    dev = hs_a.device
    va = torch.arange(hs_a.shape[1], device=dev)[None, :] < nk_a[:, None]
    vb = torch.arange(hs_b.shape[1], device=dev)[None, :] < nk_b[:, None]
    ha = torch.where(va, hs_a, _A_PAD).contiguous()
    hb = torch.where(vb, hs_b, _B_PAD).contiguous()
    lo = torch.searchsorted(ha, hb, side="left")
    return lo, torch.searchsorted(ha, hb, side="right") - lo


def join_counts(hs_a: torch.Tensor, nk_a: torch.Tensor, hs_b: torch.Tensor,
                nk_b: torch.Tensor) -> torch.Tensor:
    """Total match count per pair, without expansion: [B] int32, for tables
    as ``join_expand`` takes them."""
    return match_runs(hs_a, nk_a, hs_b, nk_b)[1].sum(dim=1).to(torch.int32)


def join_expand(hs_a: torch.Tensor, ps_a: torch.Tensor, nk_a: torch.Tensor,
                hs_b: torch.Tensor, ps_b: torch.Tensor, nk_b: torch.Tensor,
                m_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p1 [B, m_cap] int32, p2 [B, m_cap] int32, total [B] int32) for B
    pairs of hash-sorted k-mer tables: hs_* [B, W*] int64 sorted by (hash,
    pos) over the first nk_* entries, ps_* co-sorted int32 positions.  The
    two widths may differ (both >= 1)."""
    b, wa = hs_a.shape
    wb = hs_b.shape[1]
    dev = hs_a.device
    lo, cnt = match_runs(hs_a, nk_a, hs_b, nk_b)
    offs = torch.cumsum(cnt, dim=1)                        # inclusive
    total = offs[:, -1]

    # slot s belongs to the b element t with offs[t-1] <= s < offs[t]
    slots = torch.arange(m_cap, device=dev)[None, :].expand(b, m_cap)
    t = torch.searchsorted(offs, slots.contiguous(), side="right")
    t = t.clamp(max=wb - 1)
    within = slots - (torch.gather(offs, 1, t) - torch.gather(cnt, 1, t))
    a_idx = (torch.gather(lo, 1, t) + within).clamp(0, wa - 1)
    p1 = torch.gather(ps_a, 1, a_idx).to(torch.int64)
    p2 = torch.gather(ps_b, 1, t).to(torch.int64)

    valid = slots < torch.clamp(total, max=m_cap)[:, None]
    key = torch.where(valid, (p1 << 32) | p2, torch.iinfo(torch.int64).max)
    key = torch.sort(key, dim=1).values
    p1s = torch.where(valid, key >> 32, 0).to(torch.int32)
    p2s = torch.where(valid, key & 0xFFFFFFFF, INT32_MAX).to(torch.int32)
    return p1s, p2s, total.to(torch.int32)
