"""Device clustering engine: exact greedy parity at batch granularity.

Port of rattle_tpu/cluster/bulk.py.  The reference's greedy
loop (cluster.cpp:124-166) is replayed in O(N/K) decision waves:

  1. BLOCK: take the first K unclustered reads (in greedy order).  Every
     pair inside the block is decided (gate + join + LIS), and a replay of
     the sequential absorption (greedy_owner) determines which block reads
     are true seeds.  A block read can only be absorbed by an EARLIER block
     read, so seed status is exact.
  2. SWEEP: the true seeds are scored against every unclustered read after
     the block in column tiles; each such read joins the EARLIEST winning
     seed (the reference's first-claim rule).
  3. Absorbed reads leave the pool; repeat until empty.

Per pair the decision is cluster.cpp:12-65: the bitvector gate
(``kernels.gate_block``: bv_common's tensor-core tile with the gate's tests
against the f64-exact tables of ops/gates.py, the score cache's fold, the
class routing and the compaction fused in), the common-k-mer join
(``kernels.join_expand``, reading the k-mer tables in place), the LIS +
anchor filter + f32 variance (``kernels.lis_filter``) and the decision
(``kernels.score_decide``): three launches a (class, tier) range of pairs,
cut only where a launch's working set would pass LAUNCH_BYTES, where the
JAX engine runs a route of fixed-size chunks as one jitted program.  The
block replay is ``kernels.greedy_owner``, the sweep's
``kernels.absorb_rest``.  Work is routed count-first: one join at the first
M tier both counts each pair's matches and decides the pairs that fit; the
rest are cheap-rejected (bases <= k * matches) or scored at the smallest M
tier that fits.  The merge rounds (cluster.cpp:171-256) run the same
machinery over cluster representatives with the B->b->0 threshold
schedule; a score cache (outcomes are threshold-independent) spares
re-gated pairs.  Between phases the clusters are arrays over the reads
(``ClusterArrays``): a phase's membership is one lexsort and its
representatives (get_main_seq, cluster.cpp:67-91) a few segment
reductions; the ``List[Cluster]`` is built once, at the end.

Exactness escapes, rescored on the host in f64 like the reference: a match
count beyond the last M tier, and a variance within VAR_BAND_REL of t_v.

The host reads the card as the JAX engine's wave does: per strand once
after the gate (the class counts, which size the pair list and the tier-0
launches) and once after ``tier_partition`` (its count matrix, which sizes
the (class, tier) launches); per wave once at the end, one int32 vector of
each strand's border flag and the replay (JAX's wave_summary).  Only a set
flag makes it read more: the border pairs, and the replay again after their
host rescore (JAX's _rare_paths).  ``host_reads``, ``rare_reads`` and
``waves`` count them.

Unlike the JAX engine this one has no static shapes: the gated pair list is
sized exactly (the gate's class counts), so there is no pair budget to
overflow and redo, and waves are not padded to power-of-two buckets.  The
decisions are the same; every scatter's indices are unique within its call,
so plain masked index writes replace JAX's ``.at[].max(mode="drop")``.

Mesh mode (``mesh=``, a parallel.launch.DataMesh): the JAX engine lets XLA's
SPMD partitioner split its programs over the reads axis; here the split is
explicit.  Rank r holds the sketch rows of its contiguous slice of the
length-sorted reads (``shard_plan``) and decides, in every wave, the columns
it owns:

  1. the rows' forward tables are assembled on every rank from their owners
     (one allgather; a sweep reuses its block's);
  2. each rank gates and scores its own columns with the unchanged chain;
  3. the rare host rescores run where their column lives (with
     ``shard=``, the reads another rank owns are fetched first);
  4. the block's win matrix, or the sweep's packed first-claim vector, is
     allgathered, so every rank replays the same greedy sweep.

Every rank calls the same collectives in the same order, whatever its share
of the pairs.  The score cache stays on, one per rank over the pairs of its
own columns: outcomes do not depend on it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ClusterParams, bv_threshold_schedule
from ..device import resolve
from ..io.hpsio import Cluster, CSeq
from ..ops import gates
from ..ops.encode import encode_seq
from ..ops.kernels import (absorb_rest, gate_block, greedy_owner,
                           join_expand, lis_filter, score_decide,
                           score_pair_bytes)
from ..ops.sketch import PAD_HASH
from ..ops.sketch_device import (DeviceSketch, build_device_sketch,
                                 build_device_sketch_sharded)
from ..parallel import launch
from ..utils import metrics
from ..utils.varmath import var as exact_var
from . import oracle

# K classes by pair max-nk: k-mer table slice widths (0 = full kmax)
K_CLASSES: Tuple[int, ...] = (1024, 2048, 4096, 0)
# M tiers: match-list capacities; pairs route to the smallest tier that fits
# their exact match count, > last tier -> exact f64 host scorer
M_LADDER: Tuple[int, ...] = (128, 512, 2048)
# bytes one score-path launch may hold: a (class, tier) range is cut into
# launches of as many pairs as fit (``kernels.score_pair_bytes``: the [B, M]
# match lists on the card, ~900k pairs a launch at M = 128, far below the
# kernels' int pair index; the plain versions' [B, W] gathers too, a few
# thousand pairs)
LAUNCH_BYTES = 1 << 30
VAR_BAND_REL = 0.02
# sweep-phase column tiling: bounds the gate product at [k_block, SWEEP_TILE]
# regardless of N (the absorb decision is per-column, so tiles are exact)
SWEEP_TILE = 1 << 16
# above this many reads the [n^2] cross-round score cache is off (it would
# be 10 GB/strand at 100k reads); merge rounds then re-score rep pairs
CACHE_MAX_N = 1 << 14
ORACLE_CUTOVER = 48


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


# --------------------------------------------------------------------------
# per-wave device steps
# --------------------------------------------------------------------------


def launch_pairs(n: int, pair_bytes: int) -> int:
    """Pairs a score-path launch takes from a range of ``n``: as many as
    fit LAUNCH_BYTES at ``pair_bytes`` a pair, at least 1."""
    return max(1, min(n, LAUNCH_BYTES // max(1, pair_bytes)))


def tier_partition(cnt, pair_cls, lens_min, sc_tab, m_caps: Tuple[int, ...],
                   kmer_size: int, n_classes: int):
    """M-tier routing of the pairs the first tier did not fit.

    Per pair: tier key 0 = no further work (decided in tier 0, or cheap
    reject -- bases <= k * matches can never reach the score threshold),
    1..T-1 = smallest fitting M tier, T = overflow (exact host scorer).
    Returns (order, counts [n_classes, T+1] int32), both on the device:
    ``order`` sorts the pairs stably by (class, tier, match count), so every
    route is a contiguous, count-homogeneous slice (tight LIS bounds)."""
    t = len(m_caps)
    reject = kmer_size * cnt < sc_tab[lens_min]
    tier = torch.zeros_like(cnt)
    for m in m_caps:
        tier = tier + (cnt > m).to(cnt.dtype)
    tierkey = torch.where((tier == 0) | reject, 0, tier)
    key = pair_cls * (t + 1) + tierkey
    comp = key.to(torch.int64) * 2048 + torch.clamp(cnt, max=2047)
    comp, order = torch.sort(comp, stable=True)
    # each key's count from where its run starts in the sorted list (an
    # index_add_ of ones contends on a few addresses; bincount syncs)
    starts = torch.searchsorted(comp, torch.arange(
        n_classes * (t + 1) + 1, device=comp.device) * 2048)
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    return order, counts.reshape(n_classes, t + 1)


@dataclasses.dataclass
class _Sides:
    """The pairs of one wave: rows x the columns this process decides.
    ``*_np`` / ``*_ids``: global read ids on the host / the device (nk,
    lens, groups, the score cache); ``*_tab``: the rows of the tables that
    hold them; ``col_pos``: each column's position in the wave's list."""

    row_np: np.ndarray
    col_np: np.ndarray
    col_pos: np.ndarray
    row_ids: torch.Tensor
    col_ids: torch.Tensor
    row_tab: torch.Tensor
    col_tab: torch.Tensor
    bvp_rows: torch.Tensor
    bvc_rows: torch.Tensor
    row_tables: object      # cls_i -> (hs, ps) forward tables of the rows


@dataclasses.dataclass
class _Strand:
    """One strand's gated pairs after scoring, on the device: the tier-0
    list (rows, cols) with its border flags, the same pairs in
    tier_partition's order (srows, scols) with the later tiers' border and
    overflow flags, and ``flag``, int32 [1]: any of them set."""

    rev: bool
    rows: torch.Tensor
    cols: torch.Tensor
    border: torch.Tensor
    srows: torch.Tensor
    scols: torch.Tensor
    sborder: torch.Tensor
    flag: torch.Tensor


@dataclasses.dataclass
class _RowTables:
    """A wave's row reads, assembled on every mesh rank: their forward
    tables (entries past a read's nk are PAD_HASH / 0, as in the sketch)
    and 6-mer words."""

    bvp: torch.Tensor
    bvc: torch.Tensor
    hs: torch.Tensor
    ps: torch.Tensor
    widths: Sequence[int]       # the engine's class widths

    def __post_init__(self):
        self._cls: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, cls_i: int):
        """The rows' (hs, ps) at class ``cls_i``'s width."""
        got = self._cls.get(cls_i)
        if got is None:
            wid = self.widths[cls_i]
            have = self.hs.shape[1]
            if wid <= have:
                got = (self.hs[:, :wid], self.ps[:, :wid])
            else:
                pad = (self.hs.shape[0], wid - have)
                got = (torch.cat([self.hs, self.hs.new_full(pad, PAD_HASH)],
                                 1),
                       torch.cat([self.ps, self.ps.new_zeros(pad)], 1))
            self._cls[cls_i] = got
        return got

    def take(self, pos: np.ndarray) -> "_RowTables":
        idx = torch.from_numpy(pos.astype(np.int64)).to(self.hs.device)
        return _RowTables(self.bvp[idx], self.bvc[idx], self.hs[idx],
                          self.ps[idx], self.widths)


def shard_plan(world: int, rank: int, n: int) -> Tuple[int, int, int]:
    """(start, end, n_pad): rank ``rank``'s contiguous slice of the n
    length-sorted reads, by the JAX engine's rule: pad to a multiple of
    lcm(256, world), then ``n_pad // world`` rows a rank (a rank past the
    last read gets an empty slice)."""
    n_pad_to = 256 * world // math.gcd(256, world)
    n_pad = -(-n // n_pad_to) * n_pad_to
    rows = n_pad // world
    start = rank * rows
    return start, max(start, min(start + rows, n)), n_pad


# --------------------------------------------------------------------------
# cluster bookkeeping
# --------------------------------------------------------------------------


def main_positions(order: np.ndarray, starts: np.ndarray, rev: np.ndarray,
                   old: np.ndarray, repr_percentile: float) -> np.ndarray:
    """oracle.get_main_seq (cluster.cpp:67-91) for every cluster at once.

    Cluster c's members are ``order[starts[c]:starts[c + 1]]`` in their
    sorted order, ``rev`` is indexed by read, ``old[c]`` is the read its
    member list began with before the sort.  From index ``int(size * p)``
    (float64, as the reference) the first member on ``old``'s strand short
    of the last index is the representative; where none is, ``old`` is,
    even if the last member is on its strand.  Returns each
    representative's position in ``order``."""
    sizes = np.diff(starts)
    j0 = (sizes * float(repr_percentile)).astype(np.int64)
    cs = np.repeat(np.arange(len(sizes)), sizes)    # each position's cluster
    k = np.arange(len(order)) - starts[cs]
    hit = np.nonzero((k >= j0[cs]) & (k < sizes[cs] - 1)
                     & (rev[order] == rev[old][cs]))[0]
    first = np.ones(len(hit), bool)
    first[1:] = cs[hit[1:]] != cs[hit[:-1]]
    where = np.empty_like(order)
    where[order] = np.arange(len(order))
    main = where[old]
    main[cs[hit[first]]] = hit[first]
    return main


@dataclasses.dataclass
class ClusterArrays:
    """The engine's clusters between phases, over the n length-sorted reads.

    ``cid[i]``: read i's cluster, clusters in seed order; ``rev[i]``: its
    strand in that cluster; ``order``: the reads cluster by cluster, each
    cluster's in clusters.out order (length descending, then id
    descending: get_main_seq's two stable sorts), cluster c's at
    ``order[starts[c]:starts[c + 1]]``; ``main[c]``: its representative's
    position in ``order``."""

    cid: np.ndarray
    rev: np.ndarray
    order: np.ndarray
    starts: np.ndarray
    main: np.ndarray

    @classmethod
    def singletons(cls, n: int) -> "ClusterArrays":
        """Every read its own cluster: the greedy pass is the first merge."""
        ids = np.arange(n)
        return cls(ids, np.zeros(n, bool), ids, np.arange(n + 1), ids)

    @classmethod
    def of_clusters(cls, clusters: List[Cluster], n: int) -> "ClusterArrays":
        """The arrays of ``clusters`` (a checkpoint's), members in their
        listed order."""
        sizes = np.array([len(c.seqs) for c in clusters], np.int64)
        order = np.fromiter((s.seq_id for c in clusters for s in c.seqs),
                            np.int64, n)
        rev = np.empty(n, bool)
        rev[order] = np.fromiter((s.rev for c in clusters for s in c.seqs),
                                 bool, n)
        cid = np.empty(n, np.int64)
        cid[order] = np.repeat(np.arange(len(clusters)), sizes)
        starts = np.zeros(len(clusters) + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        where = np.empty(n, np.int64)
        where[order] = np.arange(n)
        main = where[np.array([c.main_seq.seq_id for c in clusters],
                              np.int64)]
        return cls(cid, rev, order, starts, main)

    def reps(self) -> np.ndarray:
        """The representatives' read ids, in cluster order."""
        return self.order[self.main]

    def merged(self, owner: np.ndarray, revf: np.ndarray, lens: np.ndarray,
               repr_percentile: float) -> "ClusterArrays":
        """The clusters after a greedy pass over ``reps()``: cluster c joins
        the group of seed cluster ``owner[c]``, its members' strands flipped
        where ``revf[c]``; groups in seed order.  A group's member list
        began with its first cluster's first member (cluster.cpp:171-256).
        ``lens``: the reads' lengths."""
        lead, group = np.unique(owner, return_index=True,
                                return_inverse=True)[1:]
        old = self.order[self.starts[lead]]
        rev = self.rev ^ revf[self.cid]
        cid = group[self.cid]
        order = np.lexsort((-np.arange(len(cid)), -lens, cid))
        starts = np.zeros(len(lead) + 1, np.int64)
        np.cumsum(np.bincount(cid, minlength=len(lead)), out=starts[1:])
        return ClusterArrays(cid, rev, order, starts,
                             main_positions(order, starts, rev, old,
                                            repr_percentile))

    def to_clusters(self) -> List[Cluster]:
        """The ``List[Cluster]`` (a CSeq a read, gene id -1; each main_seq
        one of its cluster's members), counted as ``cluster.materialize``."""
        metrics.GLOBAL.add("cluster.materialize")
        seqs = [CSeq(i, r) for i, r in zip(self.order.tolist(),
                                           self.rev[self.order].tolist())]
        st = self.starts.tolist()
        return [Cluster(seqs[m], seqs[a:b])
                for a, b, m in zip(st, st[1:], self.main.tolist())]


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


class BulkClusterEngine:
    """Drop-in ``engine`` for pipeline.run_cluster; exact reference parity."""

    def __init__(self, seqs: Sequence[str], params: ClusterParams,
                 sketch: Optional[DeviceSketch] = None,
                 groups: Optional[np.ndarray] = None, device="cuda",
                 mesh: Optional[launch.DataMesh] = None, shard=None):
        """``mesh``: decide over the ranks of a parallel.launch.DataMesh (on
        its device).  ``shard=(global_lens, start)``: per-rank input
        sharding -- ``seqs`` is only this rank's contiguous slice of the
        globally length-sorted reads, beginning at global row ``start``;
        every rank knows all read lengths but holds no other rank's
        sequences (fetched on demand by the rare host rescore)."""
        with metrics.GLOBAL.span("cluster.setup"):
            if params.use_hc:
                # unreachable from the reference CLI (no main.cpp flag sets
                # use_hc); the score path gates on `bases`
                raise NotImplementedError("use_hc not supported by the bulk "
                                          "engine; use the oracle engine")
            self.p = params
            self.mesh = mesh
            self.device = resolve(mesh.device if mesh is not None else device)
            if shard is not None:
                if mesh is None:
                    raise ValueError("shard= requires mesh=")
                global_lens, start = shard
                self.seqs = None
                self._local_seqs = {start + i: s for i, s in enumerate(seqs)}
                self.read_lens = [int(x) for x in global_lens]
            else:
                self.seqs = list(seqs)
                self._local_seqs = None
                self.read_lens = [len(s) for s in self.seqs]
            self.n = len(self.read_lens)
            self.lens_host = np.asarray(self.read_lens, np.int64)
            k = params.kmer_size
            if mesh is None:
                self.sk = sketch if sketch is not None else \
                    build_device_sketch(self.seqs, k, not params.is_rna,
                                        device=self.device)
                self.nk, self.lens = self.sk.nk, self.sk.lens
            else:
                if sketch is not None:
                    raise ValueError("sketch= and mesh= exclude each other")
                start, end, n_pad = shard_plan(mesh.world, mesh.rank, self.n)
                if shard is not None and shard[1] != start:
                    raise ValueError(f"shard starts at {shard[1]}, rank "
                                     f"{mesh.rank}'s slice at {start}")
                lens_p = np.zeros(n_pad, np.int32)
                lens_p[:self.n] = self.read_lens
                if np.any(lens_p[:self.n] <= max(k, 6)):
                    bad = int(np.argmin(lens_p[:self.n]))
                    raise ValueError(f"read {bad} too short (len "
                                     f"{lens_p[bad]}) for k={k}")
                self.row0, self.n_rows = start, n_pad // mesh.world
                local = list(seqs) if shard is not None \
                    else self.seqs[start:end]
                self.sk = build_device_sketch_sharded(
                    local, lens_p[:self.n], start, self.n_rows, k,
                    not params.is_rna, device=self.device)
                self.lens = torch.from_numpy(lens_p).to(self.device)
                self.nk = torch.where(self.lens > 0, self.lens - k, 0)
            self.nk_host = self.nk.cpu().numpy()
            self.n_remote_reads = 0
            sk = self.sk
            self.k_block = min(4096, self.n)
            self.sweep_cpad = min(SWEEP_TILE, self.n)
            # per-K-class table slices (narrower joins for shorter reads)
            full_w = _pow2_at_least(sk.kmax, 128)
            widths = sorted({min(w, full_w) for w in K_CLASSES if w}
                            | {full_w})
            self.class_bounds = widths[:-1]
            self.n_classes = len(widths)
            # entries past nk are never read
            self._cls_widths = [min(wid, sk.kmax) for wid in widths]
            self._cls_tabs = []
            for wid in self._cls_widths:
                tabs = {"hs": sk.hs[:, :wid], "ps": sk.ps[:, :wid]}
                if not params.is_rna:
                    tabs["rev_hs"] = sk.rev_hs[:, :wid]
                    tabs["rev_ps"] = sk.rev_ps[:, :wid]
                self._cls_tabs.append(tabs)
            self._bounds_dev = torch.tensor(self.class_bounds,
                                            dtype=torch.int32,
                                            device=self.device)
            # M ladder clamped to the input scale: tiers above ~kmax would run
            # giant scans for pairs the host scorer decides exactly
            top_m = _pow2_at_least(min(M_LADDER[-1], sk.kmax), M_LADDER[0])
            self.m_ladder = tuple(m for m in M_LADDER if m <= top_m) \
                or (top_m,)
            # the counters of the pairs the join scores, a (K class, M tier)
            self._pair_keys = [[f"cluster.pairs.w{wid}.m{m}"
                                for m in self.m_ladder] for wid in widths]
            self.score_min = torch.from_numpy(gates.min_numerator_table(
                max(self.read_lens), params.t_s)).to(self.device)
            self._bv_tables: Dict[float, torch.Tensor] = {}
            self._oracle_kmers: Dict[int, oracle.ReadKmers] = {}
            self._host_cache: Dict[Tuple[int, int, bool], bool] = {}
            self.n_oracle_fallbacks = 0
            self.var_band = np.float32(VAR_BAND_REL * max(self.p.t_v, 1.0))
            # cross-round score cache (outcomes are threshold-independent,
            # directional: a = seed side); 0 unscored / 1 score-no /
            # 2 score-yes.
            # uint8 [n^2] per strand: 64 MiB each at 8192 reads, 256 MiB at the
            # 16384-read cap; off (None) above it.  On a mesh each rank writes
            # only the pairs of the columns it owns.
            self.cache_n = self.n
            self._cache: Dict[bool, Optional[torch.Tensor]] = {}
            for rev in ([False] if params.is_rna else [False, True]):
                self._cache[rev] = torch.zeros(
                    self.n * self.n, dtype=torch.uint8, device=self.device) \
                    if self.n <= CACHE_MAX_N else None
            self.progress = False  # --verbose progress bar (utils.cpp:57-75)
            # utils.checkpoint.ClusterCheckpoint or None
            self.checkpoint = None
            # group constraint (--iso batching): reads in different groups are
            # never compared; default one global group
            self.groups = np.zeros(self.n, np.int32) if groups is None \
                else np.asarray(groups, np.int32)
            self._groups_dev = torch.from_numpy(self.groups).to(self.device)
            # device->host reads: of the waves' fixed schedule, of the rare
            # paths, and the most one wave made outside the rare paths
            self.waves = 0
            self.host_reads = 0
            self.rare_reads = 0
            self.wave_reads_max = 0
            self._wave_reads = 0
            self._marks: List[Tuple[Optional[str], object]] = []

    @property
    def is_writer(self) -> bool:
        """Whether this process writes shared files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    # ---------- helpers ----------

    def _bv_table(self, threshold: float) -> torch.Tensor:
        tab = self._bv_tables.get(threshold)
        if tab is None:
            tab = torch.from_numpy(
                gates.min_numerator_table(4096, threshold)).to(self.device)
            self._bv_tables[threshold] = tab
        return tab

    def _seq(self, i: int) -> str:
        """Read i's sequence; with ``shard=`` it must be this rank's or
        already fetched by _ensure_seqs."""
        if self.seqs is not None:
            return self.seqs[i]
        return self._local_seqs[i]

    def _ensure_seqs(self, ids) -> None:
        """With ``shard=``: make the reads ``ids`` (the same sorted list on
        every rank) available on every rank in ONE collective.  Owners
        contribute their reads, a max-combine assembles them.  No local
        early-out: another rank may miss a read this one owns."""
        lmax = max(self.read_lens[i] for i in ids)
        buf = np.zeros((len(ids), lmax), np.uint8)
        for r, i in enumerate(ids):
            s = self._local_seqs.get(i)
            if s is not None:
                raw = np.frombuffer(s.encode("ascii"), np.uint8)
                buf[r, :len(raw)] = raw
        got = launch.allgather_to_hosts(buf).reshape(-1, len(ids), lmax)
        tot = got.max(axis=0)
        for r, i in enumerate(ids):
            if i not in self._local_seqs:
                self._local_seqs[i] = tot[r, :self.read_lens[i]].tobytes() \
                    .decode("ascii")

    def _okm(self, i: int) -> oracle.ReadKmers:
        km = self._oracle_kmers.get(i)
        if km is None:
            km = oracle.extract_kmers(
                encode_seq(self._seq(i)), self.p.kmer_size,
                not self.p.is_rna)
            self._oracle_kmers[i] = km
        return km

    def _host_decide(self, a: int, b: int, rev: bool) -> bool:
        """Exact f64 single-pair decision (score + variance, no gate)."""
        key = (a, b, rev)
        hit = self._host_cache.get(key)
        if hit is not None:
            return hit
        self.n_oracle_fallbacks += 1
        ka, kb = self._okm(a), self._okm(b)
        if rev:
            m1, m2 = oracle.common_kmers(ka.hashes, ka.positions,
                                         kb.rev_hashes, kb.rev_positions)
        else:
            m1, m2 = oracle.common_kmers(ka.hashes, ka.positions,
                                         kb.hashes, kb.positions)
        sim = oracle.calc_similarity(m1, m2, self.p.kmer_size,
                                     self.p.hc_max_dist)
        mn = float(min(self.read_lens[a], self.read_lens[b]))
        metric = sim.hc_bases if self.p.use_hc else sim.bases
        ok = bool(metric / mn >= self.p.t_s
                  and exact_var(sim.distances) < self.p.t_v)
        self._host_cache[key] = ok
        return ok

    def _host_rescore_batch(self, batch):
        """Exact f64 decisions for (rev, a, b, row, col) jobs, batched
        through the native scorer (falls back to the Python oracle).
        Yields (rev, a, b, row, col, win)."""
        todo = []
        for rev, a, b, r_, c_ in batch:
            hit = self._host_cache.get((a, b, rev))
            if hit is None:
                todo.append((rev, a, b))
            else:
                yield rev, a, b, r_, c_, hit
        done: Dict[Tuple[int, int, bool], bool] = {}
        if todo:
            from .. import native
            from ..ops.sketch import build_sketch_tables
            if native.available():
                uniq = sorted({i for _rev, a, b in todo for i in (a, b)})
                remap = {g: i for i, g in enumerate(uniq)}
                sub = build_sketch_tables([self._seq(i) for i in uniq],
                                          self.p.kmer_size,
                                          not self.p.is_rna)
                a_ids = np.array([remap[a] for _rev, a, _b in todo], np.int32)
                b_ids = np.array([remap[b] for _rev, _a, b in todo], np.int32)
                revs = np.array([rev for rev, _a, _b in todo], bool)
                out = native.score_pairs_native(sub, a_ids, b_ids, revs,
                                                self.p.kmer_size,
                                                self.p.hc_max_dist)
                if out is not None:
                    lens = np.asarray(self.read_lens, dtype=np.int64)
                    mn = np.minimum(
                        lens[[a for _r, a, _b in todo]],
                        lens[[b for _r, _a, b in todo]]).astype(np.float64)
                    metric = out["hc"] if self.p.use_hc else out["bases"]
                    with np.errstate(invalid="ignore"):
                        ok = (metric.astype(np.float64) / mn >= self.p.t_s) \
                            & (out["var"] < self.p.t_v)
                    self.n_oracle_fallbacks += len(todo)
                    for (rev, a, b), o in zip(todo, ok):
                        done[(a, b, rev)] = bool(o)
                        self._host_cache[(a, b, rev)] = bool(o)
        for rev, a, b, r_, c_ in batch:
            key = (a, b, rev)
            if key in done:
                yield rev, a, b, r_, c_, done[key]
            elif key not in self._host_cache:
                yield rev, a, b, r_, c_, self._host_decide(a, b, rev)

    # ---------- one batched decision wave ----------

    def _score_range(self, rows, cols, cls_i: int, m_cap: int, s: _Sides,
                     rev: bool, w, consts):
        """Join + LIS decision of one (class, tier) range of (row, col) pairs
        (similarity.cpp:4-97 + cluster.cpp:24-37), no host sync: join_expand,
        lis_filter and score_decide, each launched once for every
        ``launch_pairs`` slice of the range (once for the whole range unless
        its working set passes LAUNCH_BYTES).  Wins are written into ``w``
        and decided outcomes into the score cache, in place.  Returns
        (border, total) for the range: [n] bool, variance within the f64
        band of t_v (host rescored), and [n] int32, the exact match counts.
        Each launch's bound (its largest match count within m_cap, where the
        LIS scans stop: exact) starts at 0.

        The pairs of a range are unique (the gate's), and so are their read
        pairs, so no write of one launch is read by another: where the range
        is cut does not change any output."""
        hs_a, ps_a = s.row_tables(cls_i)
        t = self._cls_tabs[cls_i]
        hs_b = t["rev_hs"] if rev else t["hs"]
        ps_b = t["rev_ps"] if rev else t["ps"]
        n = rows.shape[0]
        dev = rows.device
        step = launch_pairs(n, score_pair_bytes(
            join_expand, rows, hs_a.shape[1], hs_b.shape[1], m_cap))
        border = torch.empty(n, dtype=torch.bool, device=dev)
        total = torch.empty(n, dtype=torch.int32, device=dev)
        bounds = torch.zeros(-(-n // step), dtype=torch.int32, device=dev)
        strand_val = 1 if rev else 2
        for li, i in enumerate(range(0, n, step)):
            sl = slice(i, i + step)
            bound = bounds[li:li + 1]
            p1, p2, _t, mvalid, _b = join_expand(
                rows[sl], cols[sl], s.row_ids, s.col_ids, s.row_tab,
                s.col_tab, hs_a, ps_a, hs_b, ps_b, self.nk, m_cap,
                total=total[sl], bound=bound)
            bases, _hc, _n_dist, var = lis_filter(
                p1, p2, mvalid, self.p.kmer_size, self.p.hc_max_dist,
                bound=bound)
            score_decide(rows[sl], cols[sl], s.row_ids, s.col_ids, bases,
                         var, total[sl], self.lens, self.score_min, *consts,
                         strand_val, w, self._cache[rev], self.cache_n,
                         m_cap, border=border[sl])
        return border, total

    def _wave(self, row_ids: np.ndarray, col_ids: np.ndarray,
              threshold: float, ordered: bool,
              tables: Optional[_RowTables] = None) -> np.ndarray:
        """One decision wave: every (row, col) pair decided into a win
        matrix ``w`` (``_decide``), the replay (greedy_owner for an ordered
        block, absorb_rest for a sweep) and ONE fetch: each strand's border
        flag and the replay in one int32 vector (JAX's wave_summary).  Only
        a set flag takes the rare path (JAX's _rare_paths): the border pairs
        (borderline variance, match-count overflow) are fetched, rescored on
        the host in f64 and patched into ``w``, and the replay runs and is
        fetched again.

        ``ordered``: rows/cols are the same greedy-ordered list (block
        phase) -- only pairs with row position < col position are tested.
        Otherwise every (row, col) pair is tested (sweep phase; rows are
        seeds, all of which precede all cols in greedy order).

        ``tables``: on a mesh, the rows' tables if already assembled.
        Returns the packed replay vector (np.int32)."""
        with metrics.GLOBAL.span("cluster.wave"):
            if self.mesh is not None:
                return self._wave_mesh(row_ids, col_ids, threshold, ordered,
                                       tables)
            sk = self.sk
            dev = self.device
            a = len(row_ids)
            d_row_ids = torch.from_numpy(row_ids.astype(np.int64)).to(dev)
            d_col_ids = torch.from_numpy(col_ids.astype(np.int64)).to(dev)
            s = _Sides(row_ids, col_ids, np.arange(len(col_ids)), d_row_ids,
                       d_col_ids, d_row_ids, d_col_ids, sk.bvp[d_row_ids],
                       sk.bvc[d_row_ids],
                       lambda i: (self._cls_tabs[i]["hs"],
                                  self._cls_tabs[i]["ps"]))
            w = torch.zeros((a, len(col_ids)), dtype=torch.int8, device=dev)
            strands = self._decide(s, threshold, ordered, w)
            with metrics.GLOBAL.span("cluster.replay"):
                replay = greedy_owner(w, a) if ordered else absorb_rest(w)
                n_s = len(strands)
                summary = torch.cat([st.flag for st in strands] + [replay]) \
                    if strands else replay
                self._mark("replay")
                got = self._read(summary).numpy()
            packed = got[n_s:]
            flagged = [st for st, f in zip(strands, got[:n_s]) if f]
            if flagged:
                with metrics.GLOBAL.span("cluster.rescore"):
                    if self._patch_host(w, self._border_jobs(s, flagged,
                                                             rare=True)):
                        self._mark("rescore")
                        replay = greedy_owner(w, a) if ordered \
                            else absorb_rest(w)
                        self._mark("replay")
                        packed = self._read(replay, rare=True).numpy()
            self._end_wave()
            return packed

    def _decide(self, s: _Sides, threshold: float, ordered: bool,
                w: torch.Tensor) -> List[_Strand]:
        """Every pair of ``s`` decided into ``w`` [rows, cols], per strand:

          gate_block: gate + cache fold + class routing + compaction, then
            the read of its class counts
          tier-0 pass x class: match counts + decisions of the pairs that fit
          tier_partition: cheap-reject + M-tier routing of the rest, then
            the read of its count matrix
          score pass x (class, tier): the remaining decisions

        Returns each strand that gated a fresh pair, its border flags on the
        device (``_Strand``): borderline variance and match-count overflow,
        for the host rescore.  Counts, from the two reads: the pairs that
        pass the gate (``cluster.gate_pairs``), the pairs the join scores at
        K class width W and M tier M (``cluster.pairs.w<W>.m<M>``: every
        gated pair at the first tier, then the later tiers' routes) and
        those past the last tier (``cluster.overflow_pairs``)."""
        sk = self.sk
        dev = self.device
        a = s.row_ids.shape[0]
        c = s.col_ids.shape[0]
        tab = self._bv_table(threshold)
        group_rows = self._groups_dev[s.row_ids]
        group_cols = self._groups_dev[s.col_ids]
        bvc_cols = sk.bvc[s.col_tab]
        if ordered:
            order_rows = torch.arange(a, dtype=torch.int32, device=dev)
            order_cols = torch.from_numpy(s.col_pos.astype(np.int32)).to(dev)
        else:
            order_rows = torch.zeros(a, dtype=torch.int32, device=dev)
            order_cols = torch.ones(c, dtype=torch.int32, device=dev)
        consts = (torch.tensor(self.p.t_v, dtype=torch.float32, device=dev),
                  torch.tensor(float(self.var_band), dtype=torch.float32,
                               device=dev))
        t_lad = len(self.m_ladder)
        m0 = self.m_ladder[0]
        add = metrics.GLOBAL.add

        out: List[_Strand] = []
        strands = [False] if self.p.is_rna else [False, True]
        self._mark(None)
        for rev in strands:
            with metrics.GLOBAL.span("cluster.gate"):
                bvp_cols = (sk.rev_bvp if rev else sk.bvp)[s.col_tab]
                rows, cols, cls_dev, cls_counts = gate_block(
                    s.bvp_rows, s.bvc_rows, order_rows, group_rows,
                    bvp_cols, bvc_cols, order_cols, group_cols, tab,
                    self._cache[rev], self.cache_n, s.row_ids, s.col_ids, w,
                    1 if rev else 2, self.nk, self._bounds_dev)
                self._count_read()
                self._mark("gate")
            n = rows.shape[0]
            if n == 0:
                continue
            with metrics.GLOBAL.span("cluster.score"):
                add("cluster.gate_pairs", n)
                for i, n_c in enumerate(cls_counts):
                    if n_c:
                        add(self._pair_keys[i][0], n_c)
                # tier 0: one join per pair counts its matches and decides
                # it when they fit the first M tier
                starts = np.cumsum((0,) + cls_counts)
                first = [self._score_range(
                    rows[starts[i]:starts[i + 1]],
                    cols[starts[i]:starts[i + 1]], i, m0, s, rev, w, consts)
                    for i in range(self.n_classes) if cls_counts[i]]
                border = torch.cat([b for b, _ in first])
                cnt = torch.cat([t for _, t in first])
                ra = s.row_ids[rows]
                rb = s.col_ids[cols]
                pair_cls = torch.repeat_interleave(
                    torch.arange(self.n_classes, device=dev), cls_dev,
                    output_size=n)
                order, counts = tier_partition(
                    cnt, pair_cls,
                    torch.minimum(self.lens[ra], self.lens[rb]),
                    self.score_min, self.m_ladder, self.p.kmer_size,
                    self.n_classes)
                srows, scols = rows[order], cols[order]
                sborder = torch.zeros(n, dtype=torch.bool, device=dev)
                counts = self._read(counts).numpy()
                off = 0
                for cls_i in range(self.n_classes):
                    for tier_i in range(t_lad + 1):
                        n_r = int(counts[cls_i, tier_i])
                        sl = slice(off, off + n_r)
                        off += n_r
                        if n_r == 0 or tier_i == 0:
                            continue  # tier 0: decided or rejected above
                        if tier_i == t_lad:
                            # match-count overflow beyond the last tier:
                            # host f64
                            add("cluster.overflow_pairs", n_r)
                            sborder[sl] = True
                        else:
                            add(self._pair_keys[cls_i][tier_i], n_r)
                            sborder[sl] = self._score_range(
                                srows[sl], scols[sl], cls_i,
                                self.m_ladder[tier_i], s, rev, w, consts)[0]
                flag = (border.any() | sborder.any()).to(torch.int32) \
                    .reshape(1)
                out.append(_Strand(rev, rows, cols, border, srows, scols,
                                   sborder, flag))
                self._mark("score")
        return out

    def _border_jobs(self, s: _Sides, strands: List[_Strand],
                     rare: bool = False
                     ) -> List[Tuple[bool, int, int, int, int]]:
        """The host-rescore jobs (rev, a, b, row, col) of ``strands``: their
        border pairs, fetched in one read a strand."""
        jobs: List[Tuple[bool, int, int, int, int]] = []
        for st in strands:
            sel = torch.nonzero(st.border).flatten()
            ssel = torch.nonzero(st.sborder).flatten()
            pairs = self._read(torch.stack([
                torch.cat([st.rows[sel], st.srows[ssel]]),
                torch.cat([st.cols[sel], st.scols[ssel]])]), rare=rare)
            for rr, cc in pairs.T.tolist():
                jobs.append((st.rev, int(s.row_np[rr]), int(s.col_np[cc]),
                             rr, cc))
        return jobs

    def _assemble_rows(self, row_ids: np.ndarray) -> _RowTables:
        """The forward tables and 6-mer words of reads ``row_ids`` on every
        rank: each rank contributes the rows it owns to ONE allgather.
        Hashes travel as uint32 and widen to int64 on arrival, so PAD_HASH
        still sorts after every real hash."""
        sk = self.sk
        a = len(row_ids)
        owner = row_ids // self.n_rows
        mine = np.nonzero(owner == self.mesh.rank)[0]
        nk_max = int(self.nk_host[row_ids].max())
        width = next(w for w in self._cls_widths if w >= nk_max)
        li = torch.from_numpy((row_ids[mine] - self.row0).astype(np.int64)
                              ).to(self.device)
        parts = (sk.bvp[li].cpu().numpy(), sk.bvc[li, None].cpu().numpy(),
                 sk.hs[li, :width].cpu().numpy().astype(np.uint32),
                 sk.ps[li, :width].cpu().numpy())
        rec = np.concatenate([np.ascontiguousarray(p).view(np.uint8)
                              for p in parts], axis=1)
        got = launch.allgather_to_hosts(rec)
        full = np.empty_like(got)
        full[np.argsort(owner, kind="stable")] = got
        cuts = np.cumsum([0] + [p.shape[1] * 4 for p in parts])

        def col(i, dtype):
            return np.ascontiguousarray(full[:, cuts[i]:cuts[i + 1]]) \
                .view(dtype).reshape(a, -1)

        def dev(x):
            return torch.from_numpy(x).to(self.device)

        return _RowTables(dev(col(0, np.int32)),
                          dev(col(1, np.int32)[:, 0].copy()),
                          dev(col(2, np.uint32).astype(np.int64)),
                          dev(col(3, np.int32)), self._cls_widths)

    def _wave_mesh(self, row_ids: np.ndarray, col_ids: np.ndarray,
                   threshold: float, ordered: bool,
                   tables: Optional[_RowTables]) -> np.ndarray:
        """``_wave`` on a mesh: this rank decides the columns it owns, the
        replay runs on every rank from the allgathered decisions.  The
        collectives do not depend on this rank's share of the pairs, nor on
        its border flags: each rank reads its border pairs every wave."""
        dev = self.device
        a = len(row_ids)
        if tables is None:
            with metrics.GLOBAL.span("cluster.rows"):
                tables = self._assemble_rows(row_ids)
        owner = col_ids // self.n_rows
        col_pos = np.nonzero(owner == self.mesh.rank)[0]
        own = col_ids[col_pos]
        w = torch.zeros((a, len(own)), dtype=torch.int8, device=dev)
        host_jobs = []
        if len(own):
            d_own = torch.from_numpy(own.astype(np.int64)).to(dev)
            d_rows = torch.from_numpy(row_ids.astype(np.int64)).to(dev)
            s = _Sides(row_ids, own, col_pos, d_rows, d_own,
                       torch.arange(a, device=dev), d_own - self.row0,
                       tables.bvp, tables.bvc, tables)
            host_jobs = self._border_jobs(
                s, self._decide(s, threshold, ordered, w))
        with metrics.GLOBAL.span("cluster.rescore"):
            if self.seqs is None:
                # fetch the rescores' reads that other ranks own: the union
                # of every rank's needs, so that all ranks make the same
                # exchange
                need = sorted({i for _rev, ra, rb, _r, _c in host_jobs
                               for i in (ra, rb)} - self._local_seqs.keys())
                self.n_remote_reads += len(need)
                union = sorted(set().union(*launch.allgather_objects(need)))
                if union:
                    self._ensure_seqs(union)
            if host_jobs:
                self._patch_host(w, host_jobs)
        with metrics.GLOBAL.span("cluster.replay"):
            order = np.argsort(owner, kind="stable")
            if ordered:
                got = launch.allgather_to_hosts(
                    self._read(w.T.contiguous()).numpy())
                full = np.empty((len(col_ids), a), np.int8)
                full[order] = got
                replay = greedy_owner(
                    torch.from_numpy(full.T.copy()).to(dev), a)
                packed = self._read(replay).numpy()
            else:
                mine = self._read(absorb_rest(w)).numpy() if len(own) \
                    else np.zeros(0, np.int32)
                packed = np.empty(len(col_ids), np.int32)
                packed[order] = launch.allgather_to_hosts(mine)
        self._end_wave()
        return packed

    def _mark(self, name: Optional[str]) -> None:
        """On the card, record a timing event that ends section ``name``
        (None: the wave's first mark); the time since the previous mark is
        added to stage ``cluster.<name>_dev`` of ``utils.metrics.GLOBAL``
        when the wave ends.  A section's host span (``cluster.<name>``)
        covers the device work it waits for: the gate ends in the read of
        its class counts, the replay in the wave's one fetch, which also
        waits for the score work still queued.  Each
        wave's last mark precedes one of its reads, so every event has
        completed by then: no sync is added.  Nothing on the CPU."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._marks.append((name, ev))

    def _read(self, x: torch.Tensor, rare: bool = False) -> torch.Tensor:
        """``x`` fetched to the host, counted as a read of the wave's
        schedule or (``rare``) of a rare path.  The copy waits for the
        device work queued before it: span ``cluster.fetch``."""
        if rare:
            self.rare_reads += 1
        else:
            self._count_read()
        with metrics.GLOBAL.span("cluster.fetch"):
            return x.cpu()

    def _count_read(self) -> None:
        self.host_reads += 1
        self._wave_reads += 1

    def _end_wave(self) -> None:
        """Close the wave: its read count and its sections' device time."""
        self.waves += 1
        self.wave_reads_max = max(self.wave_reads_max, self._wave_reads)
        self._wave_reads = 0
        stages = metrics.GLOBAL.stages
        for (_n0, e0), (name, e1) in zip(self._marks, self._marks[1:]):
            key = f"cluster.{name}_dev"
            stages[key] = stages.get(key, 0.0) + e0.elapsed_time(e1) / 1e3
        self._marks.clear()

    def _patch_host(self, w, host_jobs) -> bool:
        """Borderline-variance and match-count-overflow pairs: exact f64
        host rescore (cluster.cpp exactness contract), patched into w.
        Returns whether any pair won."""
        best: Dict[Tuple[int, int], int] = {}
        for rev, _a, _b, r_, c_, ok in self._host_rescore_batch(host_jobs):
            if ok:
                val = 1 if rev else 2
                best[(r_, c_)] = max(best.get((r_, c_), 0), val)
        if not best:
            return False
        arr = torch.tensor([(r_, c_, v) for (r_, c_), v in best.items()],
                           dtype=torch.int64, device=w.device)
        cur = w[arr[:, 0], arr[:, 1]]
        w[arr[:, 0], arr[:, 1]] = torch.maximum(cur, arr[:, 2].to(torch.int8))
        return True

    # ---------- frontier greedy ----------

    def _greedy_pass(self, ids: np.ndarray, threshold: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Frontier-exact greedy absorption over ``ids`` (greedy order).
        Returns each position's seed position (its own where it is a seed)
        and its strand flag."""
        m = len(ids)
        owner = np.arange(m)
        revf = np.zeros(m, bool)
        pool = np.arange(m)
        k = self.k_block
        while len(pool):
            if self.progress:
                metrics.print_progress(m - len(pool), m)
            blk = pool[:k]
            nb = len(blk)
            tables = None
            if self.mesh is not None:
                with metrics.GLOBAL.span("cluster.rows"):
                    tables = self._assemble_rows(ids[blk])
            packed = self._wave(ids[blk], ids[blk], threshold,
                                ordered=True, tables=tables)[:nb]
            o = packed >> 1
            owner[blk] = blk[o]
            revf[blk] = (packed & 1).astype(bool)
            is_seed = o == np.arange(nb)
            seeds = blk[is_seed]
            rest = pool[k:]
            if len(rest) == 0:
                break
            if tables is not None:
                # the seeds' tables are rows of the block's
                tables = tables.take(np.nonzero(is_seed)[0])
            # all true seeds of this block sweep the remaining pool in
            # bounded column tiles (the first-claim absorb decision is
            # per-column, so tiling is exact)
            survivors = []
            for t0_col in range(0, len(rest), self.sweep_cpad):
                tile = rest[t0_col:t0_col + self.sweep_cpad]
                pk = self._wave(ids[seeds], ids[tile], threshold,
                                ordered=False, tables=tables)[:len(tile)]
                won = pk >= 0
                owner[tile[won]] = seeds[(pk[won] >> 1)]
                revf[tile[won]] = (pk[won] & 1).astype(bool)
                survivors.append(tile[~won])
            pool = np.concatenate(survivors) if survivors else rest[:0]
        if self.progress:
            metrics.print_progress(m, m)
        return owner, revf

    # ---------- public API ----------

    def cluster(self) -> List[Cluster]:
        """The greedy pass, then the merge rounds, on ``ClusterArrays``; the
        ``List[Cluster]`` is built at the end, inside the last phase's span,
        and for each checkpoint record."""
        p = self.p
        ck = self.checkpoint
        # on a mesh only rank 0 writes the manifest; every rank reads it
        # before any rank goes on (the barrier), so all resume alike
        record = ck.record if ck is not None and self.is_writer else None
        schedule = list(bv_threshold_schedule(p))
        phases_done = 0
        st = ClusterArrays.singletons(self.n)
        if ck is not None:
            resume = ck.load()
            if resume is not None:
                phases_done = resume[0]
                st = ClusterArrays.of_clusters(resume[1], self.n)
            if self.mesh is not None:
                launch.barrier()
        out = None

        if phases_done == 0:
            with metrics.GLOBAL.span("cluster.greedy"):
                st = st.merged(*self._greedy_pass(st.reps(), p.bv_threshold),
                               self.lens_host, p.repr_percentile)
                if not schedule:
                    out = st.to_clusters()
            phases_done = 1
            if record is not None:
                record(phases_done, st.to_clusters())

        with metrics.GLOBAL.span("cluster.merge"):
            for round_i, threshold in enumerate(schedule):
                if round_i + 1 < phases_done:
                    continue  # merge round already checkpointed
                st = st.merged(*self._greedy_pass(st.reps(), threshold),
                               self.lens_host, p.repr_percentile)
                phases_done = round_i + 2
                if record is not None:
                    record(phases_done, st.to_clusters())
            if out is None:
                out = st.to_clusters()
        return out


def cluster_reads_bulk(seqs: Sequence[str], params: ClusterParams,
                       progress: bool = False,
                       groups: Optional[np.ndarray] = None,
                       checkpoint_dir: Optional[str] = None,
                       device="cuda",
                       mesh: Optional[launch.DataMesh] = None
                       ) -> List[Cluster]:
    """Engine entry point for pipeline.run_cluster.

    ``groups``: optional per-read group ids.  Reads in different groups are
    never compared and sub-clusterings of all groups run in ONE batched
    device pass -- this is how --iso clusters every gene cluster's members
    at once (main.cpp:280-323).  Output order matches the reference's
    per-group emission because group member positions are contiguous and
    clusters emit in seed order.

    ``mesh``: decide over the ranks of a parallel.launch.DataMesh, every
    rank calling this with the same reads; each returns the same clusters.

    Spans and counts are added to ``utils.metrics.GLOBAL``: stages
    ``cluster.setup`` (the engine's set-up), ``cluster.greedy`` and
    ``cluster.merge`` (the phases), ``cluster.wave`` (each decision wave),
    the wave sections ``cluster.gate`` / ``score`` / ``replay`` /
    ``rescore`` (``rows`` on a mesh) and on the card their device times
    (``cluster.<section>_dev``), ``cluster.fetch`` (the host's waits in
    ``_read``); counters ``cluster.host_rescores``, ``cluster.waves``,
    ``cluster.host_reads``, ``cluster.rare_reads``,
    ``cluster.wave_reads_max``, the join's pairs (``_decide``) and
    ``cluster.materialize`` (``ClusterArrays.to_clusters``: one a run, one
    more a checkpoint record)."""
    if len(seqs) < ORACLE_CUTOVER:
        if groups is None:
            return oracle.cluster_reads(seqs, params, progress=progress)
        out: List[Cluster] = []
        g_arr = np.asarray(groups)
        for g in np.unique(g_arr):
            idx = np.nonzero(g_arr == g)[0]
            for c in oracle.cluster_reads([seqs[i] for i in idx], params):
                main = CSeq(int(idx[c.main_seq.seq_id]), c.main_seq.rev)
                mem = [CSeq(int(idx[s.seq_id]), s.rev) for s in c.seqs]
                out.append(Cluster(main, mem))
        return out
    engine = BulkClusterEngine(seqs, params, groups=groups, device=device,
                               mesh=mesh)
    engine.progress = progress
    if checkpoint_dir is not None:
        # phase-granular resume (utils/checkpoint.py ClusterCheckpoint);
        # the key guards against reusing a manifest after the inputs or
        # params changed: full length vector + a 64-read content sample
        h = hashlib.sha256(
            np.asarray([len(s) for s in seqs], np.int64).tobytes())
        for i in range(0, len(seqs), max(1, len(seqs) // 64)):
            h.update(seqs[i].encode())
        if groups is not None:
            h.update(np.asarray(groups, np.int64).tobytes())
        from ..utils.checkpoint import ClusterCheckpoint, params_key
        key = params_key(params=dataclasses.asdict(params), n=len(seqs),
                         digest=h.hexdigest())
        engine.checkpoint = ClusterCheckpoint(checkpoint_dir, key)
    return run_engine(engine)


def run_engine(engine: BulkClusterEngine) -> List[Cluster]:
    """``engine.cluster()``, then its checkpoint finalized (by the writer)
    and its counters added to ``utils.metrics.GLOBAL``."""
    out = engine.cluster()
    if engine.checkpoint is not None and engine.is_writer:
        # the returned clusters become the stage artifact immediately; the
        # manifest's job (surviving a crash mid-stage) is done
        engine.checkpoint.finalize()
    metrics.GLOBAL.add("cluster.host_rescores", engine.n_oracle_fallbacks)
    metrics.GLOBAL.add("cluster.remote_reads", engine.n_remote_reads)
    metrics.GLOBAL.add("cluster.waves", engine.waves)
    metrics.GLOBAL.add("cluster.host_reads", engine.host_reads)
    metrics.GLOBAL.add("cluster.rare_reads", engine.rare_reads)
    c = metrics.GLOBAL.counters
    c["cluster.wave_reads_max"] = max(c.get("cluster.wave_reads_max", 0),
                                      engine.wave_reads_max)
    return out
