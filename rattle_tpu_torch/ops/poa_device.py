"""Batched POA graph-vs-read alignment for the lockstep runner; port of
rattle_tpu/ops/poa_device.py with its names and contract.

Many packs advance in lockstep: lane b holds pack b's current graph (in
topological-rank space) and its next read; one call computes the full
affine-gap local DP and the traceback for all lanes.  Graph threading and
topological re-ranking happen on the host between steps
(correct/runner.py).  Same semantics and tie-breaks as the oracle
``ops/poa.py::align_local``; the kernel is ``ops/kernels.py::
poa_align_batch`` (csrc/poa_align_batch.cu on the card, its plain version on
the CPU).

Cells are stored as int16 clamped at CLAMP16 when the read width is at most
SMALL_L (no optimal-path value reaches the clamp there), else as int32, and
later rows and the traceback read the stored values.  The traceback returns
ONE packed int32 array, (rank + 1) << 16 | (pos + 1) in reverse order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .kernels import POA_CLAMP16 as CLAMP16
from .kernels import POA_NEG as NEG
from .kernels import POA_SMALL_L as SMALL_L

__all__ = ["BatchedAlignment", "CLAMP16", "NEG", "SMALL_L",
           "alignment_to_host", "poa_align_batch"]


class BatchedAlignment(NamedTuple):
    packed: torch.Tensor   # [B, N+L] int32: (rank+1) << 16 | (pos+1), reversed
    length: torch.Tensor   # [B] int32: entries used
    aligned: torch.Tensor  # [B] bool: best score > 0


def poa_align_batch(letters, preds, n_nodes, seq, seq_len, match: int = 5,
                    mismatch: int = -4, go: int = -8, ge: int = -6,
                    scratch=None) -> BatchedAlignment:
    """letters [B, N] uint8 raw chars; preds [B, N, PMAX] int16 or int32
    (pred RANK + 1, 0 = virtual start, -1 = padding); n_nodes [B] int32;
    seq [B, L] uint8 (0 pad); seq_len [B] int32.  ``scratch``: see
    ``kernels.poa_align_batch``."""
    return BatchedAlignment(*kernels.poa_align_batch(
        letters, preds, n_nodes, seq, seq_len, match, mismatch, go, ge,
        scratch=scratch))


def alignment_to_host(res: BatchedAlignment, lane: int, rank_nodes,
                      seq_len: int):
    """Convert lane ``lane`` of a result (numpy arrays or host tensors) into
    the oracle's Alignment format: list of (node_id, seq_pos) in forward
    order with unaligned prefix/suffix entries (ops/poa.py align_local's
    contract)."""
    if len(rank_nodes) == 0:
        return []  # empty graph: align_local's n == 0 case
    ln = int(res.length[lane])
    if not bool(res.aligned[lane]):
        return [(-1, j) for j in range(seq_len)]
    pk = np.asarray(res.packed[lane, :ln])[::-1].astype(np.int64)
    nodes = (pk >> 16) - 1
    pos = (pk & 0xFFFF) - 1
    ids = np.where(nodes >= 0,
                   np.asarray(rank_nodes)[np.maximum(nodes, 0)], -1)
    aln = list(zip(ids.tolist(), pos.tolist()))
    hit = np.flatnonzero(pos != -1)
    first_j = int(pos[hit[0]]) if hit.size else 0
    last_j = int(pos[hit[-1]]) if hit.size else -1
    prefix = [(-1, x) for x in range(first_j)]
    suffix = [(-1, x) for x in range(last_j + 1, seq_len)]
    return prefix + aln + suffix
