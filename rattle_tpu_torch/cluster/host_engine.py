# Copied from rattle_tpu/cluster/host_engine.py; docstring adapted to the port.
"""Exact host clustering engine: NumPy bitvector gate + native C++ scoring.

A CPU twin of the device engine with identical results: a batched greedy
sweep (seed batch vs unclustered pool) whose per-pair decisions all run in
float64 (bit-identical to the reference's doubles — no threshold tables or
borderline bands needed); pair scores come from the native C++ scorer
(tests prove it bit-equal to the oracle, including the NaN variance quirk).

In the port nothing selects it on its own (no fallback when the card is
missing): it is reached only by an explicit import, as the honest CPU
baseline of benchmarks.  Reference semantics: cluster.cpp:93-259.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ClusterParams, bv_threshold_schedule
from ..io.hpsio import CSeq, Cluster
from ..ops.sketch import build_sketch_tables
from .. import native
from . import oracle

SEED_BATCH = 48


class HostClusterEngine:
    """Batched greedy replay (cluster.cpp:124-256); decisions on the host."""

    def __init__(self, seqs: Sequence[str], params: ClusterParams):
        # deliberately skip the TPU parent __init__: no device arrays
        self.seqs = list(seqs)
        self.p = params
        self.n = len(seqs)
        self.read_lens = [len(s) for s in seqs]
        self.tables = build_sketch_tables(self.seqs, params.kmer_size,
                                          not params.is_rna)
        self.nk_host = self.tables.nk
        self._oracle_kmers = {}
        self.n_oracle_fallbacks = 0
        if not native.available():
            raise RuntimeError("native library unavailable")

        # bit-expanded f32 bitvectors: the gate popcount becomes one sgemm
        t = self.tables
        self._bits = np.unpackbits(
            t.bvp.view(np.uint8), axis=1, bitorder="little").astype(np.float32)
        if not params.is_rna:
            self._rev_bits = np.unpackbits(
                t.rev_bvp.view(np.uint8), axis=1, bitorder="little"
            ).astype(np.float32)
        self._lens_arr = np.asarray(self.read_lens, dtype=np.int64)

    def _decide_pairs(self, seeds: np.ndarray, pool: np.ndarray,
                      threshold: float,
                      seed_reads: Optional[np.ndarray] = None,
                      pool_reads: Optional[np.ndarray] = None):
        if seed_reads is None:
            seed_reads = seeds
        if pool_reads is None:
            pool_reads = pool
        t = self.tables
        p_ids = np.asarray(pool_reads, dtype=np.int64)
        s_ids = np.asarray(seed_reads, dtype=np.int64)

        common = self._bits[p_ids] @ self._bits[s_ids].T          # [P, S]
        mmax = np.maximum(t.bvc[p_ids][:, None],
                          t.bvc[s_ids][None, :]).astype(np.float64)
        fwd_gate = (threshold == 0) | (common.astype(np.float64) / mmax >= threshold)
        decision = np.zeros((len(pool), len(seeds)), np.int8)

        def strand(gate, rev: bool, exclude=None):
            pi, si = np.nonzero(gate if exclude is None else (gate & exclude))
            if len(pi) == 0:
                return
            out = native.score_pairs_native(
                t, s_ids[si], p_ids[pi], np.full(len(pi), rev, bool),
                self.p.kmer_size, self.p.hc_max_dist)
            mn = np.minimum(self._lens_arr[s_ids[si]],
                            self._lens_arr[p_ids[pi]]).astype(np.float64)
            metric = out["hc"] if self.p.use_hc else out["bases"]
            norm_ok = metric.astype(np.float64) / mn >= self.p.t_s
            with np.errstate(invalid="ignore"):
                var_ok = out["var"] < self.p.t_v  # NaN compares False
            win = norm_ok & var_ok
            decision[pi[win], si[win]] = 2 if rev else 1

        strand(fwd_gate, rev=False)
        if not self.p.is_rna:
            rev_common = self._rev_bits[p_ids] @ self._bits[s_ids].T
            rev_gate = rev_common.astype(np.float64) / mmax >= threshold
            strand(rev_gate, rev=True, exclude=decision == 0)
        return decision

    def _greedy(self, order: np.ndarray, threshold: float,
                seed_reads_of: Optional[np.ndarray] = None):
        """Batched greedy sweep over ``order`` (ascending positions):
        a fixed-size batch of still-unclustered seeds is decided against the
        whole unclustered pool at once; absorption replays the reference's
        sequential first-claim order (cluster.cpp:124-166)."""
        n = len(order)
        already = np.zeros(n, bool)
        groups: List[Tuple[int, List[Tuple[int, bool]]]] = []
        reads_of = seed_reads_of if seed_reads_of is not None else order

        pos = 0
        while pos < n:
            seed_positions = []
            q = pos
            while q < n and len(seed_positions) < SEED_BATCH:
                if not already[q]:
                    seed_positions.append(q)
                q += 1
            if not seed_positions:
                break
            seed_positions = np.array(seed_positions)
            pool_positions = np.nonzero(~already)[0]
            pool_positions = pool_positions[pool_positions > seed_positions[0]]
            if len(pool_positions) == 0:
                for sp in seed_positions:
                    if not already[sp]:
                        already[sp] = True
                        groups.append((int(order[sp]),
                                       [(int(order[sp]), False)]))
                pos = q
                continue

            decision = self._decide_pairs(
                order[seed_positions], order[pool_positions], threshold,
                seed_reads=reads_of[seed_positions],
                pool_reads=reads_of[pool_positions])

            for col, sp in enumerate(seed_positions):
                if already[sp]:
                    continue  # absorbed by an earlier seed in this batch
                already[sp] = True
                members = [(int(order[sp]), False)]
                dcol = decision[:, col]
                for row, pp in enumerate(pool_positions):
                    if already[pp] or pp <= sp:
                        continue
                    if dcol[row]:
                        already[pp] = True
                        members.append((int(order[pp]), dcol[row] == 2))
                groups.append((int(order[sp]), members))
            pos = q
            while pos < n and already[pos]:
                pos += 1
        return groups

    def cluster(self) -> List[Cluster]:
        p = self.p
        order = np.arange(self.n)

        # --- greedy seeding (cluster.cpp:124-166) ---
        groups = self._greedy(order, p.bv_threshold)
        clusters: List[Cluster] = []
        for _seed, members in groups:
            cseqs = [CSeq(m, r) for m, r in members]
            main = oracle.get_main_seq(cseqs, self.read_lens,
                                       p.repr_percentile)
            clusters.append(Cluster(main, cseqs))

        # --- merge rounds (cluster.cpp:171-256) ---
        for threshold in bv_threshold_schedule(p):
            nc = len(clusters)
            cluster_ids = np.arange(nc)
            reps = np.array([c.main_seq.seq_id for c in clusters])
            merge_groups = self._greedy(cluster_ids, threshold,
                                        seed_reads_of=reps)
            tmp: List[Cluster] = []
            for _seed_cid, members in merge_groups:
                merged = Cluster(CSeq(-1, False), [])
                for cid, rev in members:
                    for s in clusters[cid].seqs:
                        merged.seqs.append(
                            CSeq(s.seq_id, (not s.rev) if rev else s.rev,
                                 s.gene_id))
                merged.main_seq = oracle.get_main_seq(
                    merged.seqs, self.read_lens, p.repr_percentile)
                tmp.append(merged)
            clusters = tmp
        return clusters


def cluster_reads_host(seqs: Sequence[str], params: ClusterParams) -> List[Cluster]:
    if len(seqs) < 8 or not native.available():
        return oracle.cluster_reads(seqs, params)
    return HostClusterEngine(seqs, params).cluster()
