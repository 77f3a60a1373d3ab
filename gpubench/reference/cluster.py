"""Plain reference of ``cluster``: RATTLE's greedy gene clustering in NumPy.

It follows the decision rules of comprna/RATTLE, the same that the port's
scalar oracle (``cluster/oracle.py``) states, and imports nothing of the
program:

* k-mers at positions [0, L-k), 6-mer presence at [0, L-6) .... kmer.cpp:6-42
* every (pos1, pos2) pair of equal hashes, by (pos1, pos2) ...... kmer.cpp:45-67
* patience LIS, then the same-side-of-k anchor filter ....... similarity.cpp
* the bitvector gate, then score and variance gates ......... cluster.cpp:12-65
* representative choice, greedy seeding, merge rounds ....... cluster.cpp:67-259
* compensated two-pass sample variance ...................... utils.cpp:26-55

The decisions are the same; only their order of evaluation differs, for speed.
A pair's decision is a pure function of the two reads and the threshold, so
the pairs of a block of consecutive seeds are decided together before the
sequential bookkeeping walks the block: the pool of a later seed only
shrinks, so the block's candidates are a superset of what the walk asks.
Common k-mers come from one inverted index of all reads; the patience LIS of
pairs with few matches runs in lockstep over arrays, that of longer pairs
one by one as in similarity.cpp.

``match_cap`` keeps only each pair's first matches: the control, which the
comparison with the program has to tell apart from the reference.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

BV_KMER = 6
BV_SIZE = 4 << (2 * (BV_KMER - 1))      # 4096
# the pairs of one width (a power of two of matches) take the lockstep LIS
# where they are at least this many, else one by one: a lockstep step costs
# about as much as 30 matches walked one by one
LOCKSTEP_ROWS = 40
# matches expanded at once (bounds the memory of a block)
BLOCK_MATCHES = 1 << 22
BLOCK_SEEDS = 256

_CODE = np.zeros(256, np.uint8)
for _ch, _c in (("A", 0), ("C", 1), ("T", 2), ("U", 2), ("G", 3)):
    _CODE[ord(_ch)] = _c


@dataclass(frozen=True)
class Params:
    """cluster's flags (main.cpp:200-218)."""

    kmer_size: int = 10
    t_s: float = 0.2
    t_v: float = 1000000.0
    bv_start: float = 0.4
    bv_end: float = 0.2
    bv_falloff: float = 0.05
    repr_percentile: float = 0.15
    rna: bool = False
    # > 0: each pair keeps only its first match_cap matches (a control)
    match_cap: int = 0


def schedule(p: Params) -> List[float]:
    """Merge-round thresholds: B - f stepping down by f while >= b, then
    0.0, accumulated in doubles as cluster.cpp:171-256 does; none at all if
    B - f < b."""
    out: List[float] = []
    cur = p.bv_start - p.bv_falloff
    if cur < p.bv_end:
        return out
    while cur >= p.bv_end:
        out.append(cur)
        cur -= p.bv_falloff
    out.append(0.0)
    return out


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit big-endian hash of every k-mer (kmer.hpp:33-40), low 32 bits."""
    n = len(codes) - k + 1
    out = np.zeros(max(n, 0), np.uint64)
    c = codes.astype(np.uint64)
    for t in range(k):
        out += c[t:t + n] << np.uint64(2 * (k - 1 - t))
    return (out & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _strand(codes: np.ndarray, k: int):
    """(hashes sorted by (hash, pos), co-sorted positions, 6-mer presence)."""
    length = len(codes)
    h = kmer_hashes(codes, k)[:length - k]
    pos = np.arange(length - k, dtype=np.int64)
    order = np.lexsort((pos, h))
    bv = np.zeros(BV_SIZE, bool)
    bv[kmer_hashes(codes, BV_KMER)[:length - BV_KMER]] = True
    return h[order], pos[order], bv


class _Index:
    """Every read's k-mers of one strand, sorted by (hash, read, pos), and
    for each k-mer of each read's forward strand (``queries``, by (hash,
    pos)) the run of equal hashes here: ``lo``, ``cnt``, both concatenated
    over the reads from ``off``."""

    def __init__(self, hs: List[np.ndarray], ps: List[np.ndarray],
                 queries: List[np.ndarray]):
        reads = np.repeat(np.arange(len(hs)), [len(h) for h in hs])
        h, p = np.concatenate(hs), np.concatenate(ps)
        rb = max(1, len(hs).bit_length())
        pb = max(1, int(p.max(initial=0)).bit_length())
        if 32 + rb + pb > 63:
            raise ValueError("reads too long or too many for the sort key")
        key = np.sort((((h << rb) | reads) << pb) | p)
        self.hash = key >> (rb + pb)
        self.read = (key >> pb) & ((1 << rb) - 1)
        self.pos = key & ((1 << pb) - 1)
        q = np.concatenate(queries)
        self.lo = np.searchsorted(self.hash, q, "left")
        self.cnt = np.searchsorted(self.hash, q, "right") - self.lo
        self.off = np.concatenate([[0], np.cumsum([len(x) for x in queries])])


class _Var:
    """Sample variance as utils.cpp:26-55 computes it, in one precision, of
    each row's first ``n`` entries: sums in the loops' order, var([]) = 0,
    var([x]) = NaN."""

    def __init__(self, dtype):
        self.f = np.dtype(dtype).type

    def rows(self, d: np.ndarray, n: np.ndarray) -> np.ndarray:
        f = self.f
        rows, w = d.shape
        df = d.astype(f)
        res = np.zeros(rows, f)
        for t in range(w):
            res = np.where(t < n, res + df[:, t], res)
        nf = n.astype(f)
        with np.errstate(invalid="ignore", divide="ignore"):
            m = res / nf
            ss = np.zeros(rows, f)
            comp = np.zeros(rows, f)
            for t in range(w):
                dv = df[:, t] - m
                on = t < n
                ss = np.where(on, ss + dv * dv, ss)
                comp = np.where(on, comp + dv, comp)
            num = ss - comp * comp / nf
            out = num / (nf - f(1))
        out = np.where(n == 1, f(np.nan), out)
        return np.where(n == 0, f(0), out)


def _lis_filter_one(m1: np.ndarray, m2: np.ndarray, k: int
                    ) -> Tuple[int, List[int]]:
    """similarity.cpp:4-97 for one pair: (bases, distances)."""
    n = len(m1)
    m1 = m1.tolist()
    m2 = m2.tolist()
    p = [0] * n
    m = [0] * (n + 1)
    tails = [0]
    length = 0
    for i in range(n):
        v = m2[i]
        new_l = bisect.bisect_left(tails, v, 1, length + 1)
        p[i] = m[new_l - 1]
        m[new_l] = i
        if new_l > length:
            length = new_l
            tails.append(v)
        else:
            tails[new_l] = v
    s = [0] * length
    j = m[length]
    for i in range(length - 1, -1, -1):
        s[i] = j
        j = p[j]
    bases, dists = 0, []
    lf = ls = 0
    for i in range(length):
        a1, a2 = m1[s[i]], m2[s[i]]
        if i == 0:
            lf, ls, bases = a1, a2, k
            continue
        d1, d2 = a1 - lf, a2 - ls
        if (d1 < k and d2 < k) or (d1 >= k and d2 >= k):
            ex = k - (a2 - m2[s[i - 1]])
            bases += k - ex if ex > 0 else k
            dists.append(d2 - d1)
            lf, ls = a1, a2
    return bases, dists


def _lis_filter_rows(M1: np.ndarray, M2: np.ndarray, cnt: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``_lis_filter_one`` in lockstep over rows of [P, w] matches, each row's
    first ``cnt`` valid: (bases [P], distances [P, w], their counts [P])."""
    P, w = M2.shape
    # rows by count, most first, so that the rows still walking at a step
    # are a prefix; columns contiguous
    order = np.argsort(-cnt, kind="stable")
    cnt = cnt[order]
    M1T, M2T = np.ascontiguousarray(M1[order].T), np.ascontiguousarray(
        M2[order].T)
    alive = np.searchsorted(-cnt, -np.arange(w), "left")  # rows with cnt > t
    rows = np.arange(P)
    rowkey = rows << 33
    # tails of levels 1..w, as row * 2^33 + value so that one searchsorted
    # over the flattened array bisects each row (unused levels hold 2^32)
    flat = (rowkey[:, None] + (np.int64(1) << 32)).repeat(w, 1).reshape(-1)
    top = np.zeros(P * (w + 1), np.int64)   # m: the index ending each level
    predT = np.zeros((w, P), np.int64)
    length = np.zeros(P, np.int64)
    for t in range(w):
        n = alive[t]
        if n == 0:
            break
        q = rowkey[:n] + M2T[t, :n]
        # new_l, 1-based: past the last tail where q is above it (the common
        # case of colinear matches), else a bisection of the row's tails
        ln = length[:n]
        last = flat[np.maximum(rows[:n] * w + ln - 1, 0)]
        lvl = ln + 1
        inner = np.nonzero((ln > 0) & (q <= last))[0]
        if len(inner):
            lvl[inner] = np.searchsorted(flat, q[inner]) - inner * w + 1
        at = rows[:n] * (w + 1) + lvl
        predT[t, :n] = top[at - 1]
        top[at] = t
        flat[rows[:n] * w + lvl - 1] = q
        np.maximum(length[:n], lvl, out=length[:n])
    # the LIS of each row, rows by length, most first
    by_len = np.argsort(-length, kind="stable")
    length_s = length[by_len]
    alive = np.searchsorted(-length_s, -np.arange(w), "left")
    cur = top[by_len * (w + 1) + length_s]
    seqT = np.zeros((w, P), np.int64)
    for i in range(w - 1, -1, -1):
        n = alive[i]
        if n == 0:
            continue
        on = i < length_s[:n]
        c = cur[:n]
        seqT[i, :n] = np.where(on, c, 0)
        cur[:n] = np.where(on, predT[c, by_len[:n]], c)
    A1 = M1T[seqT, by_len[None, :]]
    A2 = M2T[seqT, by_len[None, :]]
    bases = np.where(length_s > 0, k, 0).astype(np.int64)
    lf, ls, prev2 = A1[0].copy(), A2[0].copy(), A2[0].copy()
    distT = np.zeros((w, P), np.int64)
    nd = np.zeros(P, np.int64)
    for i in range(1, w):
        n = alive[i]
        if n == 0:
            break
        a1, a2 = A1[i, :n], A2[i, :n]
        d1, d2 = a1 - lf[:n], a2 - ls[:n]
        keep = ((d1 < k) & (d2 < k)) | ((d1 >= k) & (d2 >= k))
        ex = k - (a2 - prev2[:n])
        bases[:n] += np.where(keep, np.where(ex > 0, k - ex, k), 0)
        kr = np.nonzero(keep)[0]
        distT[nd[kr], kr] = (d2 - d1)[kr]
        nd[kr] += 1
        lf[kr], ls[kr] = a1[kr], a2[kr]
        prev2[:n] = a2
    # back to the callers' row order
    out_b = np.empty(P, np.int64)
    out_d = np.empty((P, w), np.int64)
    out_n = np.empty(P, np.int64)
    src = order[by_len]
    out_b[src], out_d[src], out_n[src] = bases, distT.T, nd
    return out_b, out_d, out_n


class Reference:
    """The clustering of one read set (length-sorted, as main.cpp:254 sorts)."""

    def __init__(self, seqs: Sequence[str], p: Params):
        self.p = p
        self.f = np.float64
        self.var = _Var(self.f)
        k = p.kmer_size
        self.n = len(seqs)
        self.lens = np.array([len(s) for s in seqs], np.int64)
        if self.n and self.lens.min() <= max(k, BV_KMER):
            raise ValueError("a read is too short for k")
        fw = [_strand(_CODE[np.frombuffer(s.encode(), np.uint8)], k)
              for s in seqs]
        self.hs = [x[0] for x in fw]
        self.ps = [x[1] for x in fw]
        bv = np.stack([x[2] for x in fw]).astype(np.float32)
        self.bvc = bv.sum(1).astype(np.int64)
        # common 6-mers of every pair: sums of 0/1 products below 2^24 are
        # exact in float32
        self.common = {False: (bv @ bv.T).astype(np.int16)}
        self.index = {False: _Index(self.hs, self.ps, self.hs)}
        # a pair's score and variance outcome once decided: -1 not yet
        self.known = {False: np.full((self.n, self.n), -1, np.int8)}
        if not p.rna:
            rv = [_strand(_CODE[np.frombuffer(s.encode(), np.uint8)][::-1] ^ 2,
                          k) for s in seqs]
            rbv = np.stack([x[2] for x in rv]).astype(np.float32)
            self.common[True] = (bv @ rbv.T).astype(np.int16)
            self.index[True] = _Index([x[0] for x in rv], [x[1] for x in rv],
                                      self.hs)
            self.known[True] = np.full((self.n, self.n), -1, np.int8)

    # -- one threshold's gates -------------------------------------------

    def _ratio_ok(self, common: np.ndarray, mmax: np.ndarray, thr: float):
        f = self.f
        return common.astype(f) / mmax.astype(f) >= f(thr)

    def _decide(self, seeds: np.ndarray, cand: np.ndarray, thr: float
                ) -> np.ndarray:
        """[B, n] int8 for seed reads ``seeds`` against the reads marked in
        ``cand`` (the block's pools): 1 a forward match, 2 a reverse one,
        0 none, as cluster_together (cluster.cpp:12-65) decides at ``thr``;
        also 0 outside the bitvector pre-gate."""
        p = self.p
        mmax = np.maximum(self.bvc[seeds][:, None], self.bvc[None, :])
        fwd_gate = cand & ((thr == 0) |
                           self._ratio_ok(self.common[False][seeds], mmax,
                                          thr))
        out = np.zeros(cand.shape, np.int8)
        out[self._passes(seeds, fwd_gate, False)] = 1
        if not p.rna:
            rev_gate = cand & (out == 0) & self._ratio_ok(
                self.common[True][seeds], mmax, thr)
            out[self._passes(seeds, rev_gate, True)] = 2
        return out

    def _passes(self, seeds: np.ndarray, gate: np.ndarray, rev: bool
                ) -> np.ndarray:
        """[B, n] bool: the pairs in ``gate`` whose score and variance pass
        (norm >= t_s and var < t_v).  A pair's outcome does not depend on
        the threshold, so it is kept (``known``) for the later rounds that
        ask again while both of its representatives stay."""
        p, f = self.p, self.f
        b_idx, r_idx = np.nonzero(gate)
        out = np.zeros(gate.shape, bool)
        if len(b_idx) == 0:
            return out
        known = self.known[rev]
        was = known[seeds[b_idx], r_idx]
        new = was < 0
        if new.any():
            b_new, r_new = b_idx[new], r_idx[new]
            fresh = np.zeros(gate.shape, bool)
            fresh[b_new, r_new] = True
            bases, var = self._scores(seeds, fresh, b_new, r_new, rev)
            mn = np.minimum(self.lens[seeds[b_new]], self.lens[r_new])
            with np.errstate(invalid="ignore"):
                ok = (bases.astype(f) / mn.astype(f) >= f(p.t_s)) & \
                    (var < f(p.t_v))
            known[seeds[b_new], r_new] = ok
            was[new] = ok
        hit = was > 0
        out[b_idx[hit], r_idx[hit]] = True
        return out

    def _scores(self, seeds, gate, b_idx, r_idx, rev):
        """(bases, variance) of the pairs (seeds[b_idx], r_idx), in that
        order, on ``rev``'s strand of the candidates."""
        ix = self.index[rev]
        k = self.p.kmer_size
        sl = [np.arange(ix.off[s], ix.off[s + 1]) for s in seeds]
        kq = np.concatenate(sl)
        pq = np.concatenate([self.ps[s] for s in seeds])
        bq = np.repeat(np.arange(len(seeds)), [len(x) for x in sl])
        lo, cnt = ix.lo[kq], ix.cnt[kq]
        total = int(cnt.sum())
        g = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(total)
        r = ix.read[g]
        b = np.repeat(bq, cnt)
        keep = gate[b, r]
        # one sort of (pair, pos1, pos2) packed in an int64 key
        pb = int(self.lens.max()).bit_length()
        pair = b[keep] * self.n + r[keep]
        if (len(seeds) * self.n).bit_length() + 2 * pb > 63:
            raise ValueError("reads too long or too many for the sort key")
        key = np.sort((((pair << pb) | np.repeat(pq, cnt)[keep]) << pb)
                      | ix.pos[g][keep])
        mask = (1 << pb) - 1
        p2 = key & mask
        p1 = (key >> pb) & mask
        pair_key = key >> (2 * pb)
        # one row a pair, in (b, r) order as np.nonzero(gate) lists them
        want = b_idx * self.n + r_idx
        starts = np.searchsorted(pair_key, want, "left")
        counts = np.searchsorted(pair_key, want, "right") - starts
        if self.p.match_cap:
            counts = np.minimum(counts, self.p.match_cap)
        bases = np.zeros(len(want), np.int64)
        var = np.zeros(len(want), self.f)
        # rows by width, powers of two; a wide width with few rows goes one
        # pair at a time
        width = np.ones(len(want), np.int64)
        nz = counts > 1
        width[nz] = np.left_shift(1, np.ceil(np.log2(counts[nz]))
                                  .astype(np.int64))
        one_by_one = []
        for w in np.unique(width):
            rows = np.nonzero(width == w)[0]
            if len(rows) < LOCKSTEP_ROWS:
                one_by_one.append(rows)
                continue
            c = counts[rows]
            t = np.arange(w)[None, :]
            at = np.minimum(starts[rows][:, None] + t, max(len(key) - 1, 0))
            on = t < c[:, None]
            M1 = np.where(on, p1[at], 0) if len(key) else np.zeros(on.shape,
                                                                   np.int64)
            M2 = np.where(on, p2[at], 0) if len(key) else M1
            bs, dist, nd = _lis_filter_rows(M1, M2, c, k)
            bases[rows] = bs
            var[rows] = self.var.rows(dist, nd)
        big = np.concatenate(one_by_one) if one_by_one else []
        if len(big):
            dists = []
            for row in big:
                s0, c = starts[row], counts[row]
                bases[row], d = _lis_filter_one(p1[s0:s0 + c], p2[s0:s0 + c],
                                                k)
                dists.append(d)
            nd = np.array([len(d) for d in dists])
            dist = np.zeros((len(big), max(1, nd.max())), np.int64)
            for i, d in enumerate(dists):
                dist[i, :len(d)] = d
            var[big] = self.var.rows(dist, nd)
        return bases, var

    # -- the greedy pass and merge rounds --------------------------------

    def _blocks(self, order: np.ndarray, done: np.ndarray, seed_read):
        """Blocks of consecutive not-``done`` entries of ``order`` from the
        current position, cut so that a block's expanded k-mer matches stay
        within BLOCK_MATCHES; yields each block's entries."""
        pos = 0
        n = len(order)
        while pos < n:
            while pos < n and done[order[pos]]:
                pos += 1
            if pos == n:
                return
            blk = []
            mass = 0
            j = pos
            while j < n and len(blk) < BLOCK_SEEDS:
                e = order[j]
                if not done[e]:
                    m = len(self.hs[seed_read(e)]) * 64
                    if blk and mass + m > BLOCK_MATCHES:
                        break
                    blk.append(e)
                    mass += m
                j += 1
            yield np.array(blk, np.int64)
            pos = j

    def _walk(self, units: int, reads_of, thr: float):
        """One pass of seeds over ``units`` (reads in the greedy pass,
        clusters in a merge round): each unit not yet taken seeds a group
        of itself and every later free unit whose read it matches.  Returns
        [(seed, [(unit, rev)])]."""
        taken = np.zeros(units, bool)
        reads = np.array([reads_of(u) for u in range(units)], np.int64)
        unit_of = np.full(self.n, -1, np.int64)
        unit_of[reads] = np.arange(units)
        groups = []
        for blk in self._blocks(np.arange(units), taken, reads_of):
            # the block's pools as they are now: later free units
            cand = np.zeros((len(blk), self.n), bool)
            free = np.nonzero(~taken)[0]
            for bi, u in enumerate(blk):
                cand[bi, reads[free[free > u]]] = True
            dec = self._decide(reads[blk], cand, thr)
            for bi, u in enumerate(blk):
                if taken[u]:
                    continue
                taken[u] = True
                hit = np.nonzero(dec[bi])[0]
                js = unit_of[hit]
                ok = ~taken[js]
                order = np.argsort(js[ok], kind="stable")
                js, revs = js[ok][order], (dec[bi, hit][ok][order] == 2)
                taken[js] = True
                groups.append((int(u), [(int(j), bool(r))
                                        for j, r in zip(js, revs)]))
        return groups

    def _main_seq(self, seqs: List[Tuple[int, bool]]):
        """cluster.cpp:67-91: sorts ``seqs`` in place (stable by id
        descending, then by length descending) and returns the member that
        represents it."""
        old = seqs[0]
        seqs.sort(key=lambda c: -c[0])
        seqs.sort(key=lambda c: -self.lens[c[0]])
        nsid = int(len(seqs) * self.p.repr_percentile)
        ns = seqs[nsid]
        while ns[1] != old[1] and nsid < len(seqs) - 1:
            nsid += 1
            ns = seqs[nsid]
        return old if nsid == len(seqs) - 1 else ns

    def cluster(self) -> List[Tuple[Tuple[int, bool], List[Tuple[int, bool]]]]:
        """[(main, members)] over local (sorted) read ids, as the reference's
        cluster_reads returns them."""
        clusters = []
        for seed, hits in self._walk(self.n, lambda u: u, self.p.bv_start):
            seqs = [(seed, False)] + hits
            clusters.append((self._main_seq(seqs), seqs))
        for thr in schedule(self.p):
            merged = []
            for seed, hits in self._walk(len(clusters),
                                         lambda u: clusters[u][0][0], thr):
                seqs = []
                for c, rev in [(seed, False)] + hits:
                    seqs += [(s, (not r) if rev else r)
                             for s, r in clusters[c][1]]
                merged.append((self._main_seq(seqs), seqs))
            clusters = merged
        return clusters


def cluster_file_order(seqs: Sequence[str], p: Params, lower: int = 150,
                       upper: int = 100000):
    """cluster mode on reads in their file's order (main.cpp:133-324): the
    length window and the N filter, the stable length-descending sort, the
    clustering, and ids mapped back to file indices.  [(main, members)]
    with (file index, rev) entries."""
    kept = [i for i, s in enumerate(seqs)
            if lower <= len(s) <= upper and "N" not in s]
    order = sorted(kept, key=lambda i: -len(seqs[i]))
    out = Reference([seqs[i] for i in order], p).cluster()
    return [((order[m[0]], m[1]), [(order[s], r) for s, r in mem])
            for m, mem in out]
