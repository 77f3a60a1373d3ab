# Copied from rattle_tpu/cluster/oracle.py.
"""Exact NumPy/Python oracle for the clustering engine.

This is a semantics-faithful reimplementation (NOT a translation) of the
reference pipeline's decision rules, used as the ground truth that the TPU
kernels are tested against:

* k-mer extraction ranges/hashing .... kmer.cpp:6-42, kmer.hpp:33-40
* common-k-mer intersection ......... kmer.cpp:45-67
* patience LIS + anchor filter ...... similarity.cpp:4-97
* pair gates (bv / score / var) ..... cluster.cpp:12-65
* representative selection .......... cluster.cpp:67-91
* greedy seeding + merge rounds ..... cluster.cpp:93-259

All float comparisons are done in float64, which is bit-identical to the C++
doubles, including the NaN quirk of single-element variance (utils.cpp:36-55).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ClusterParams, bv_threshold_schedule
from ..io.hpsio import Cluster, CSeq
from ..ops.encode import encode_seq, kmer_hashes, revcomp_codes
from ..utils.varmath import var

BV_KMER = 6
BV_SIZE = 4 << (2 * (BV_KMER - 1))  # 4096 (kmer.hpp:14-15)


@dataclass
class ReadKmers:
    """Sorted k-mer table + 6-mer presence bitvector for one read."""

    hashes: np.ndarray      # uint32, sorted by (hash, pos)
    positions: np.ndarray   # int32, co-sorted
    bv: np.ndarray          # bool[4096]
    rev_hashes: Optional[np.ndarray] = None
    rev_positions: Optional[np.ndarray] = None
    rev_bv: Optional[np.ndarray] = None
    bv_count: int = 0
    rev_bv_count: int = 0


def extract_kmers(codes: np.ndarray, k: int, both_strands: bool) -> ReadKmers:
    """kmer.cpp:6-42.  K-mer list covers positions [0, L-k) — the final k-mer
    is excluded (the vector is sized ``L-k``); the bitvector covers 6-mers at
    positions [0, L-6)."""
    length = len(codes)
    if length <= k or length <= BV_KMER:
        raise ValueError(f"read of length {length} too short for k={k}")

    def one_strand(c: np.ndarray):
        h_all = kmer_hashes(c, k)[: length - k]
        pos = np.arange(length - k, dtype=np.int32)
        order = np.lexsort((pos, h_all))
        bv = np.zeros(BV_SIZE, dtype=bool)
        bv[kmer_hashes(c, BV_KMER)[: length - BV_KMER]] = True
        return h_all[order], pos[order], bv

    h, p, bv = one_strand(codes)
    rk = ReadKmers(h, p, bv, bv_count=int(bv.sum()))
    if both_strands:
        rh, rp, rbv = one_strand(revcomp_codes(codes))
        rk.rev_hashes, rk.rev_positions, rk.rev_bv = rh, rp, rbv
        rk.rev_bv_count = int(rbv.sum())
    return rk


def common_kmers(h1: np.ndarray, p1: np.ndarray, h2: np.ndarray, p2: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """kmer.cpp:45-67: all (pos1, pos2) pairs with equal hashes (full cross
    product for duplicate hashes), sorted by (pos1, pos2)."""
    lo = np.searchsorted(h2, h1, side="left")
    hi = np.searchsorted(h2, h1, side="right")
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    starts = np.cumsum(cnt) - cnt
    out_row = np.repeat(np.arange(len(h1)), cnt)
    within = np.arange(total) - np.repeat(starts, cnt)
    m1 = p1[out_row]
    m2 = p2[np.repeat(lo, cnt) + within]
    order = np.lexsort((m2, m1))
    return m1[order].astype(np.int32), m2[order].astype(np.int32)


@dataclass
class SimilarityRes:
    """similarity.hpp:7-13."""

    lis: List[Tuple[int, int]] = field(default_factory=list)
    llis: int = 0
    bases: int = 0
    hc_bases: int = 0
    distances: List[int] = field(default_factory=list)


def calc_similarity(m1: Sequence[int], m2: Sequence[int], kmer_size: int,
                    hc_max_dist: int = 10) -> SimilarityRes:
    """similarity.cpp:4-97: patience LIS (strictly increasing in pos2) over
    the (pos1, pos2) matches, then the same-side-of-k anchor filter with
    overlap-clipped base counting.  Quirk preserved: the overlap clip ``ex``
    uses the previous raw LIS element s[i-1], not the previous KEPT anchor
    (similarity.cpp:62)."""
    n = len(m1)
    res = SimilarityRes()
    if n == 0:
        return res

    # patience LIS: m[l] = index of the smallest tail of an increasing
    # subsequence of length l; p[i] = predecessor of i.
    p = [0] * n
    m = [0] * (n + 1)
    tails: List[int] = [0]  # tails[l] mirrors m2[m[l]] for l >= 1
    l = 0
    import bisect

    for i in range(n):
        v = m2[i]
        # count of tails (levels 1..l) with value < v, strictly
        new_l = bisect.bisect_left(tails, v, lo=1, hi=l + 1)
        p[i] = m[new_l - 1]
        m[new_l] = i
        if new_l > l:
            l = new_l
            tails.append(v)
        else:
            tails[new_l] = v

    # recover the LIS
    s = [0] * l
    k = m[l]
    for i in range(l - 1, -1, -1):
        s[i] = k
        k = p[k]

    bases = 0
    hc_bases = 0
    final: List[Tuple[int, int]] = []
    distances: List[int] = []
    for i in range(l):
        a1, a2 = int(m1[s[i]]), int(m2[s[i]])
        if i > 0:
            lf, ls = final[-1]
            d1 = a1 - lf
            d2 = a2 - ls
            if (d1 < kmer_size and d2 < kmer_size) or (d1 >= kmer_size and d2 >= kmer_size):
                bases += kmer_size
                ex = kmer_size - (a2 - int(m2[s[i - 1]]))
                if ex > 0:
                    bases -= ex
                final.append((a1, a2))
                dist = (final[-1][1] - final[-2][1]) - (final[-1][0] - final[-2][0])
                distances.append(dist)
                if dist < hc_max_dist:
                    hc_bases += kmer_size
                    if ex > 0:
                        hc_bases -= ex
        else:
            final.append((a1, a2))
            bases += kmer_size
            hc_bases += kmer_size

    res.lis = final
    res.llis = len(final)
    res.bases = bases
    res.hc_bases = hc_bases
    res.distances = distances
    return res


def cluster_together(read_lens: Sequence[int], km: List[ReadKmers], i: int, j: int,
                     p: ClusterParams, bv_threshold: float) -> Optional[CSeq]:
    """cluster.cpp:12-65: two-phase pair gate.  Returns the matched CSeq
    (j, rev) or None."""
    ki, kj = km[i], km[j]
    bv_common = int(np.count_nonzero(ki.bv & kj.bv))
    mmax = float(max(ki.bv_count, kj.bv_count))

    if bv_threshold == 0 or bv_common / mmax >= bv_threshold:
        m1, m2 = common_kmers(ki.hashes, ki.positions, kj.hashes, kj.positions)
        sim = calc_similarity(m1, m2, p.kmer_size, p.hc_max_dist)
        mn = float(min(read_lens[i], read_lens[j]))
        norm = (sim.hc_bases if p.use_hc else sim.bases) / mn
        if norm >= p.t_s and var(sim.distances) < p.t_v:
            return CSeq(j, False)

    if p.is_rna:
        return None

    rev_bv_common = int(np.count_nonzero(ki.bv & kj.rev_bv))
    if rev_bv_common / mmax >= bv_threshold:
        m1, m2 = common_kmers(ki.hashes, ki.positions, kj.rev_hashes, kj.rev_positions)
        sim = calc_similarity(m1, m2, p.kmer_size, p.hc_max_dist)
        mn = float(min(read_lens[i], read_lens[j]))
        norm = (sim.hc_bases if p.use_hc else sim.bases) / mn
        if norm >= p.t_s and var(sim.distances) < p.t_v:
            return CSeq(j, True)

    return None


def get_main_seq(seqs: List[CSeq], read_lens: Sequence[int],
                 repr_percentile: float) -> CSeq:
    """cluster.cpp:67-91.  NOTE: sorts ``seqs`` in place (stable by seq_id
    desc, then stable by length desc) exactly like the reference — the caller's
    member order IS this sorted order in clusters.out."""
    old = seqs[0]
    seqs.sort(key=lambda c: -c.seq_id)
    seqs.sort(key=lambda c: -read_lens[c.seq_id])
    nsid = int(len(seqs) * repr_percentile)
    ns = seqs[nsid]
    while ns.rev != old.rev and nsid < len(seqs) - 1:
        nsid += 1
        ns = seqs[nsid]
    if nsid == len(seqs) - 1:
        return old
    return ns


def cluster_reads(seqs: Sequence[str], p: ClusterParams,
                  precomputed: Optional[List[ReadKmers]] = None,
                  progress: bool = False) -> List[Cluster]:
    """cluster.cpp:93-259: greedy seeding then iterative merge rounds.

    ``seqs`` must already be length-sorted descending (main.cpp:254 sorts
    before calling)."""
    n = len(seqs)
    read_lens = [len(s) for s in seqs]
    km = precomputed
    if km is None:
        km = [extract_kmers(encode_seq(s), p.kmer_size, not p.is_rna) for s in seqs]

    # --- greedy seeding (cluster.cpp:124-166) ---
    already = np.zeros(n, dtype=bool)
    clusters: List[Cluster] = []
    bv_matrix = np.stack([k.bv for k in km]) if n else np.zeros((0, BV_SIZE), bool)
    bv_counts = np.array([k.bv_count for k in km])
    rev_bv_matrix = None
    if not p.is_rna:
        rev_bv_matrix = np.stack([k.rev_bv for k in km])

    def candidate_mask(i: int, threshold: float, pool: np.ndarray) -> np.ndarray:
        """Vectorized bv pre-gate for seed i over candidate read ids ``pool``:
        returns pool entries that might pass either strand's bv gate."""
        if len(pool) == 0:
            return pool
        common = (bv_matrix[pool] & bv_matrix[i]).sum(axis=1)
        mmax = np.maximum(bv_counts[pool], bv_counts[i]).astype(np.float64)
        ok = (threshold == 0) | (common / mmax >= threshold)
        if rev_bv_matrix is not None:
            rev_common = (rev_bv_matrix[pool] & bv_matrix[i]).sum(axis=1)
            ok |= rev_common / mmax >= threshold
        return pool[ok]

    for i in range(n):
        if progress:
            from ..utils.metrics import print_progress
            print_progress(i, n)  # cluster.cpp:126
        if already[i]:
            continue
        already[i] = True
        cseqs = [CSeq(i, False)]
        pool = np.nonzero(~already[i + 1:])[0] + i + 1
        for j in candidate_mask(i, p.bv_threshold, pool):
            sinfo = cluster_together(read_lens, km, i, int(j), p, p.bv_threshold)
            if sinfo is not None:
                already[sinfo.seq_id] = True
                cseqs.append(sinfo)
        main = get_main_seq(cseqs, read_lens, p.repr_percentile)
        clusters.append(Cluster(main, cseqs))

    # --- iterative merge rounds (cluster.cpp:171-256) ---
    for threshold in bv_threshold_schedule(p):
        nc = len(clusters)
        already = np.zeros(nc, dtype=bool)
        reps = np.array([c.main_seq.seq_id for c in clusters])
        tmp: List[Cluster] = []
        for i in range(nc):
            if progress:
                from ..utils.metrics import print_progress
                print_progress(i, nc)  # cluster.cpp:178
            if already[i]:
                continue
            already[i] = True
            to_merge = [CSeq(i, False)]
            pool_c = np.nonzero(~already[i + 1:])[0] + i + 1
            ri = int(reps[i])
            if len(pool_c):
                cand_reads = candidate_mask(ri, threshold, reps[pool_c])
                cand_set = set(int(x) for x in cand_reads)
                survivors = [int(c) for c in pool_c if int(reps[c]) in cand_set]
            else:
                survivors = []
            for j in survivors:
                sinfo = cluster_together(read_lens, km, ri, int(reps[j]), p, threshold)
                if sinfo is not None:
                    already[j] = True
                    to_merge.append(CSeq(j, sinfo.rev))
            merged = Cluster(CSeq(-1, False), [])
            original = to_merge[0]
            for c in to_merge:
                for s in clusters[c.seq_id].seqs:
                    rev = (not s.rev) if c.rev != original.rev else s.rev
                    merged.seqs.append(CSeq(s.seq_id, rev, s.gene_id))
            merged.main_seq = get_main_seq(merged.seqs, read_lens, p.repr_percentile)
            tmp.append(merged)
        clusters = tmp

    return clusters
