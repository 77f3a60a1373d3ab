"""The clustering path's two kernels, each beside its plain PyTorch version.

* ``bv_common``  -- csrc/bv_common.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::bv_common_matmul.
* ``lis_filter`` -- csrc/lis_filter.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::lis_filter_pallas.

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and takes the
plain version only because its tensors lie on the CPU; there is no fallback
from one to the other.  Each wrapper counts its kernel launches in a plain
integer attribute (``bv_common.launches``, ``lis_filter.launches``) so a run
can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _ext
from .lis_select import (anchor_filter_select, lis_build_select,
                         lis_reconstruct_select)
from .similarity import variance

BV_WORDS = 128          # 4096-bit vectors, packed
BV_BITS = BV_WORDS * 32


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device, width: Optional[int] = None) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: expected {ndim}-d {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if width is not None and t.shape[-1] != width:
        raise ValueError(f"{name}: expected last dim {width}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# --------------------------------------------------------------------------
# bitvector gate: popcount(AND) for every (pool, seed) pair
# --------------------------------------------------------------------------


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[N, 128] int32 packed words -> [N, 4096] uint8 bit plane, bit h at
    column h (word h >> 5, bit h & 31: ops/sketch.py _pack_bv order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], BV_BITS).to(torch.uint8)


def bv_common_plain(pool: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack both sides to 0/1 planes and contract them in
    float32 (exact: every partial sum is an integer <= 4096 < 2^24)."""
    a = unpack_bits(pool).to(torch.float32)
    b = unpack_bits(seed).to(torch.float32)
    return (a @ b.T).to(torch.int32)


def bv_common(pool: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """pool [P, 128] int32, seed [S, 128] int32 -> [P, S] int32 counts of
    common set bits.  Zero rows are inert; no shape padding is needed."""
    dev = pool.device
    _check("bv_common pool", pool, torch.int32, 2, dev, BV_WORDS)
    _check("bv_common seed", seed, torch.int32, 2, dev, BV_WORDS)
    if not _on_card(pool):
        return bv_common_plain(pool, seed)
    if pool.data_ptr() % 16 or seed.data_ptr() % 16:
        raise ValueError("bv_common: rows must be 16-byte aligned (uint4 "
                         "loads)")
    p, s = pool.shape[0], seed.shape[0]
    out = torch.empty((p, s), dtype=torch.int32, device=dev)
    if p == 0 or s == 0:
        return out
    fn = _ext.load("bv_common").bv_common_launch
    _raise_on(fn(pool.data_ptr(), seed.data_ptr(), out.data_ptr(), p, s,
                 _stream(dev)), "bv_common")
    bv_common.launches += 1
    return out


bv_common.launches = 0


# --------------------------------------------------------------------------
# fused LIS + anchor filter + variance
# --------------------------------------------------------------------------


def lis_filter_plain(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                     kmer_size: int, hc_max_dist: int = 10,
                     bound: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain version: the select scans of ops/lis_select.py and the variance
    of ops/similarity.py.  ``bound`` truncates the scans at the first
    ``bound`` match slots, as the kernel does."""
    if bound is not None:
        m = max(0, min(int(bound.reshape(-1)[0]), p1.shape[1]))
        p1, p2, valid = p1[:, :m], p2[:, :m], valid[:, :m]
    p_pred, m_idx, l = lis_build_select(p2, valid)
    s_arr = lis_reconstruct_select(p_pred, m_idx, l).to(torch.int64)
    a1 = torch.gather(p1, 1, s_arr)
    a2 = torch.gather(p2, 1, s_arr)
    bases, hc, kept, dist_arr = anchor_filter_select(a1, a2, l, kmer_size,
                                                     hc_max_dist)
    n_dist = torch.clamp(kept - 1, min=0)
    return bases, hc, n_dist, variance(dist_arr, n_dist)


def lis_filter(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
               kmer_size: int, hc_max_dist: int = 10,
               bound: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """Fused LIS + filter + variance for [B, M] match lists sorted by
    (p1, p2): p1, p2 int32, valid bool.  Returns (bases, hc, n_dist [B]
    int32, var [B] float32).

    ``bound``: optional int32 scalar tensor on the same device, the largest
    valid match count of the batch; all three scans stop there (exact when
    it is that maximum).  The kernel reads it on the device, so passing it
    costs no host sync."""
    dev = p1.device
    _check("lis_filter p1", p1, torch.int32, 2, dev)
    _check("lis_filter p2", p2, torch.int32, 2, dev, p1.shape[1])
    _check("lis_filter valid", valid, torch.bool, 2, dev, p1.shape[1])
    if p2.shape[0] != p1.shape[0] or valid.shape[0] != p1.shape[0]:
        raise ValueError("lis_filter: p1, p2 and valid must share [B, M]")
    if bound is not None:
        _check("lis_filter bound", bound.reshape(-1), torch.int32, 1, dev, 1)
    if not _on_card(p1):
        return lis_filter_plain(p1, p2, valid, kmer_size, hc_max_dist, bound)
    b, m = p1.shape
    if bound is None:
        bound = torch.full((1,), m, dtype=torch.int32, device=dev)
    bound = bound.reshape(1).contiguous()
    bases = torch.empty((b,), dtype=torch.int32, device=dev)
    hc = torch.empty_like(bases)
    n_dist = torch.empty_like(bases)
    var = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return bases, hc, n_dist, var
    scratch = torch.empty((6, m + 1, b), dtype=torch.int32, device=dev)
    fn = _ext.load("lis_filter").lis_filter_launch
    _raise_on(fn(p1.data_ptr(), p2.data_ptr(), valid.data_ptr(),
                 bound.data_ptr(), b, m, kmer_size, hc_max_dist,
                 scratch.data_ptr(), bases.data_ptr(), hc.data_ptr(),
                 n_dist.data_ptr(), var.data_ptr(), _stream(dev)),
              "lis_filter")
    lis_filter.launches += 1
    return bases, hc, n_dist, var


lis_filter.launches = 0


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    bv_common.launches = 0
    lis_filter.launches = 0


def launches() -> dict:
    """Both kernels' launch counts since the last ``reset_launches``."""
    return {"bv_common": bv_common.launches,
            "lis_filter": lis_filter.launches}
