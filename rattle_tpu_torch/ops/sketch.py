# Copied from rattle_tpu/ops/sketch.py.
"""Device-resident k-mer sketch tables.

Builds the columnar arrays the batched scoring kernels consume:

* ``hbp``  [N, K] uint32 — k-mer hash at each position (position order)
* ``hs``   [N, K] uint32 — hashes sorted by (hash, pos) per read
* ``ps``   [N, K] int32  — positions co-sorted with ``hs``
* ``nk``   [N]    int32  — real k-mer count (= len - k, kmer.cpp:9)
* ``bvp``  [N, 128] uint32 — packed 4096-bit 6-mer presence bitvector
* ``bvc``  [N]    int32  — set-bit count
* rev_* variants for the reverse-complement strand (cDNA mode)

Semantics follow kmer.cpp:6-42: k-mer positions cover [0, L-k) (the final
k-mer is excluded), bitvector 6-mers cover [0, L-6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .encode import encode_seq, kmer_hashes, revcomp_codes

BV_KMER = 6
BV_SIZE = 4 << (2 * (BV_KMER - 1))  # 4096
BV_WORDS = BV_SIZE // 32            # 128


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class SketchTables:
    """Host (numpy) staging of the device tables; arrays ready to device_put."""

    hbp: np.ndarray
    hs: np.ndarray
    ps: np.ndarray
    nk: np.ndarray
    lens: np.ndarray
    bvp: np.ndarray
    bvc: np.ndarray
    rev_hs: Optional[np.ndarray] = None
    rev_ps: Optional[np.ndarray] = None
    rev_bvp: Optional[np.ndarray] = None
    kmer_size: int = 10

    @property
    def n_reads(self) -> int:
        return len(self.nk)

    @property
    def kmax(self) -> int:
        return self.hbp.shape[1]


PAD_HASH = np.uint32(0xFFFFFFFF)


def _pack_bv(bv_hashes: np.ndarray) -> np.ndarray:
    words = np.zeros(BV_WORDS, dtype=np.uint32)
    if len(bv_hashes):
        uniq = np.unique(bv_hashes)
        np.bitwise_or.at(words, uniq >> 5, np.uint32(1) << (uniq & np.uint32(31)))
    return words


def build_sketch_tables(seqs: List[str], kmer_size: int, both_strands: bool,
                        kmax: Optional[int] = None,
                        use_native: bool = True) -> SketchTables:
    n = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    nk = (lens - kmer_size).astype(np.int32)
    if np.any(nk <= 0) or np.any(lens <= BV_KMER):
        bad = int(np.argmax(nk <= 0))
        raise ValueError(f"read {bad} too short (len {lens[bad]}) for k={kmer_size}")
    if kmax is None:
        kmax = _round_up(int(nk.max()), 128)

    if use_native:
        from .. import native  # noqa: PLC0415 (lazy: optional dependency)
        if native.available():
            t = native.build_sketch_native(seqs, kmer_size, both_strands, kmax)
            if t is not None:
                return t

    hbp = np.full((n, kmax), PAD_HASH, dtype=np.uint32)
    hs = np.full((n, kmax), PAD_HASH, dtype=np.uint32)
    ps = np.zeros((n, kmax), dtype=np.int32)
    bvp = np.zeros((n, BV_WORDS), dtype=np.uint32)
    rev_hs = np.full((n, kmax), PAD_HASH, dtype=np.uint32) if both_strands else None
    rev_ps = np.zeros((n, kmax), dtype=np.int32) if both_strands else None
    rev_bvp = np.zeros((n, BV_WORDS), dtype=np.uint32) if both_strands else None

    for i, s in enumerate(seqs):
        codes = encode_seq(s)
        m = int(nk[i])
        h_all = kmer_hashes(codes, kmer_size)[:m]
        hbp[i, :m] = h_all
        order = np.lexsort((np.arange(m), h_all))
        hs[i, :m] = h_all[order]
        ps[i, :m] = order
        bvp[i] = _pack_bv(kmer_hashes(codes, BV_KMER)[: len(s) - BV_KMER])
        if both_strands:
            rc = revcomp_codes(codes)
            rh_all = kmer_hashes(rc, kmer_size)[:m]
            rorder = np.lexsort((np.arange(m), rh_all))
            rev_hs[i, :m] = rh_all[rorder]
            rev_ps[i, :m] = rorder
            rev_bvp[i] = _pack_bv(kmer_hashes(rc, BV_KMER)[: len(s) - BV_KMER])

    bvc = np.array([int(np.bitwise_count(w).sum()) for w in bvp], dtype=np.int32)
    return SketchTables(hbp=hbp, hs=hs, ps=ps, nk=nk, lens=lens, bvp=bvp, bvc=bvc,
                        rev_hs=rev_hs, rev_ps=rev_ps, rev_bvp=rev_bvp,
                        kmer_size=kmer_size)
