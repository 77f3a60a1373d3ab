# Frozen from chip_smoke.py (PEAK_*, POA_OPS_PER_CELL, _gate_row's, _join_bound's and poa_align's bound arithmetic), as functions of counts.
"""Peaks of one NVIDIA H100 SXM and the least time a kernel's work needs.

A kernel's roofline share is its bound over its measured device time, the
bound being the larger of its operations over the peak rate of their kind and
its bytes over the HBM rate.  The counts these functions take (the pairs that
pass the gate, the entries of the rows a join reads, the DP cells of a POA
step) are seen only inside the program; no metric reads them yet.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA's data sheet, SXM part at 700 W: HBM3 bytes/s and dense int8 ops/s
# on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
# assumed: int32 ops/s outside the tensor cores, half the published 67
# TFLOP/s float32 rate (an SM has 64 int32 lanes to its 128 float32 lanes)
PEAK_INT32 = 33.5e12
# measured, not published: wgmma .b1 AND+POPC from shared memory, the
# fastest 1-bit rate csrc/mma_rate.cu timed on the card (11.2-12.8 POP/s)
PEAK_B1 = 12.21e15
# integer operations poa_align spends on one DP cell
POA_OPS_PER_CELL = 32
# bytes of a read's vectors that the gate reads
GATE_VEC_BYTES = 24


def _bound(nbytes: float, ops: float, peak_ops: float) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def gate_block(a: int, c: int, passing: int, cached_wins: int, fresh: int,
               cache_on: bool) -> Tuple[float, str]:
    """One gate over a x c reads: 4096-bit products of every pair against
    the words, vectors, cache bytes of the passing pairs, cached wins, the
    fresh-pair mask and the pair list."""
    nbytes = ((a + c) * 512 + (a + c) * GATE_VEC_BYTES + 4097 * 4
              + (passing if cache_on else 0) + 2 * cached_wins
              + a * -(-c // 32) * 4 + fresh * 16)
    return _bound(nbytes, 2 * a * c * 4096, PEAK_B1)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def join_expand(pairs: int, entries: int, rows: int, kept: int, m_cap: int,
                merge_ops: int) -> Tuple[float, str]:
    """One join launch: pair indices, the distinct rows' hashes (``entries``
    of ``rows`` rows) and the kept matches' positions read once, the [pairs,
    m_cap] lists written once, against the merges of each pair's rows
    (``merge_ops``: na + nb summed) and the sort of its kept matches."""
    out_bytes = pairs * (9 * m_cap + 4) + 4
    nbytes = (16 * pairs + 8 * entries + 20 * rows
              + min(8 * kept, 4 * entries) + out_bytes)
    lg = max(2, _pow2(m_cap)).bit_length() - 1
    ops = merge_ops + pairs * _pow2(m_cap) / 2 * lg * (lg + 1) / 2
    return _bound(nbytes, ops, PEAK_INT32)


def poa_align(cells: int, nbytes: int) -> Tuple[float, str]:
    """One read step: its DP cells at POA_OPS_PER_CELL int32 operations
    against its live graph rows, reads and moves."""
    return _bound(nbytes, cells * POA_OPS_PER_CELL, PEAK_INT32)
