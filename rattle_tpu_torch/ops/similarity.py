"""The f32 variance gate (utils.cpp:36-55); port of
rattle_tpu/ops/similarity.py::_variance.  The rest of that module (the
binary-search join and gather scans) has no counterpart here: the join is
``ops/join_device.py`` and the LIS is ``ops/kernels.py``."""

from __future__ import annotations

import torch


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
