"""Plain reference of ``cluster``: RATTLE's greedy gene clustering in NumPy,
with its scalar loops in C (``cluster_ref.c``).

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
The candidates, the free units after the block's first, are dealt to shares,
one a thread.  A share holds its reads' 6-mer bitvectors and an index of
their k-mers by hash, and decides every seed of the block against its
candidates in C, which runs outside the interpreter's lock.  Nothing grows
with the pairs: a block's decisions are [seeds, share], and the shares are
dealt anew from the free units once half of them are taken.

``match_cap`` keeps only each pair's first matches: the control, which the
comparison with the program has to tell apart from the reference.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from . import native

BV_KMER = 6
BV_SIZE = 4 << (2 * (BV_KMER - 1))      # 4096
BV_WORDS = BV_SIZE // 64
# the index has a row a hash: 4^k of them
MAX_K = 12
# reads hashed at once (bounds the temporaries)
CHUNK = 4096
# seeds decided together: a block grows to twice the seeds its last block
# really had (the rest were taken by an earlier seed of the block), within
# these bounds
BLOCK_SEEDS = (4, 256)

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


def share_of_cores() -> int:
    """The threads of one reference: the cores that the harness's host pool
    gives each of its processes (``OMP_NUM_THREADS``), else all."""
    return int(os.environ.get("OMP_NUM_THREADS") or os.cpu_count() or 1)


def _array(dtype, ndim=1):
    return np.ctypeslib.ndpointer(dtype, ndim, flags="C_CONTIGUOUS")


def _declare(lib: ctypes.CDLL) -> None:
    i32, i64, f64 = _array(np.int32), _array(np.int64), _array(np.float64)
    u8, u64 = _array(np.uint8, 2), _array(np.uint64, 2)
    c_int, c_double = ctypes.c_int, ctypes.c_double
    lib.gate.argtypes = [c_int, c_int, u64, i32, u64, i32, c_double, u8]
    lib.gate.restype = None
    lib.decide.argtypes = [c_int, c_int, i64, i32, i32, i64, i64, i32, i32,
                           i64, c_int, c_int, c_double, c_double, u8]
    lib.decide.restype = c_int
    lib.lis.argtypes = [c_int, i64, i32, i32, c_int, i32, f64]
    lib.lis.restype = c_int


def _lib() -> ctypes.CDLL:
    return native.load("cluster_ref.c", _declare, ("-ffp-contract=off",))


def lis_filter(off: np.ndarray, m1: np.ndarray, m2: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """similarity.cpp:4-97 and the variance of utils.cpp:26-55 on match
    lists (pair p's (pos1, pos2) are m1, m2 [off[p], off[p + 1]), by (pos1,
    pos2)): (bases [P], variance [P]); ``cluster_ref.c``'s ``lis``."""
    n = len(off) - 1
    bases, var = np.zeros(n, np.int32), np.zeros(n, np.float64)
    if _lib().lis(n, np.ascontiguousarray(off, np.int64),
                  np.ascontiguousarray(m1, np.int32),
                  np.ascontiguousarray(m2, np.int32), k, bases, var):
        raise MemoryError("lis: out of memory")
    return bases, var


def _gather(codes: np.ndarray, off: np.ndarray, reads: np.ndarray,
            rev: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The codes of ``reads`` (each reverse-complemented with ``rev``),
    concatenated, and where each starts (one more at the end)."""
    lens = off[reads + 1] - off[reads]
    at = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(lens, out=at[1:])
    i = np.arange(at[-1])
    if rev:
        return codes[np.repeat(off[reads + 1] - 1 + at[:-1], lens) - i] ^ 2, at
    return codes[np.repeat(off[reads] - at[:-1], lens) + i], at


def _kmers(c: np.ndarray, at: np.ndarray, k: int):
    """(hash, read, position) of each read's k-mers at positions [0, L-k),
    by (read, position), in codes ``c`` whose reads start at ``at``: the
    2-bit big-endian hash of kmer.hpp:33-40, its low 32 bits."""
    n = max(len(c) - k + 1, 0)
    h = np.zeros(n, np.uint32)
    for t in range(k):
        h <<= np.uint32(2)
        h |= c[t:t + n]
    per = np.maximum(np.diff(at) - k, 0)
    first = np.zeros(len(per), np.int64)
    np.cumsum(per[:-1], out=first[1:])
    read = np.repeat(np.arange(len(per)), per)
    pos = np.arange(int(per.sum())) - np.repeat(first, per)
    return h[at[:-1][read] + pos], read, pos


def _kmer_table(reads: "_Reads", rd: np.ndarray, k: int, rev: bool = False):
    """``_kmers`` of the reads ``rd`` (reads by their place in ``rd``),
    a chunk of reads at a time."""
    parts = [(np.zeros(0, np.uint32), np.zeros(0, np.int32),
              np.zeros(0, np.int32))]
    for lo in range(0, len(rd), CHUNK):
        h, read, pos = _kmers(*_gather(reads.codes, reads.off,
                                       rd[lo:lo + CHUNK], rev), k)
        parts.append((h, (read + lo).astype(np.int32), pos.astype(np.int32)))
    return [np.concatenate(x) for x in zip(*parts)]


def _bitvectors(reads: "_Reads", rd: np.ndarray, rev: bool):
    """The 6-mer presence of reads ``rd`` at positions [0, L-6), packed in
    BV_WORDS words a read, and its count."""
    h, read, _pos = _kmer_table(reads, rd, BV_KMER, rev)
    present = np.zeros((len(rd), BV_SIZE), bool)
    present[read, h] = True
    return (np.packbits(present, axis=1, bitorder="little").view(np.uint64),
            present.sum(1, dtype=np.int32))


class _Reads:
    """The reads' codes, concatenated from ``off``, their lengths, and each
    read's bitvector and its count, of the forward strand and, in cDNA, of
    the reverse one (``rbits``; its gate divides by the forward counts)."""

    def __init__(self, seqs: Sequence[str], both: bool, pool):
        self.lens = np.array([len(s) for s in seqs], np.int64)
        self.off = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(self.lens, out=self.off[1:])
        self.codes = _CODE[np.frombuffer("".join(seqs).encode(), np.uint8)]
        chunks = [np.arange(lo, min(lo + CHUNK, len(seqs)))
                  for lo in range(0, len(seqs), CHUNK)]

        def strand(rev):
            parts = list(pool.map(lambda rd: _bitvectors(self, rd, rev),
                                  chunks))
            return (np.concatenate([np.zeros((0, BV_WORDS), np.uint64)]
                                   + [b for b, _c in parts]),
                    np.concatenate([np.zeros(0, np.int32)]
                                   + [c for _b, c in parts]))
        self.bits, self.count = strand(False)
        self.rbits = strand(True)[0] if both else None


class _Share:
    """One thread's candidates: their units, reads, lengths, bitvectors and
    counts, and for each strand (forward, then reverse in cDNA) its
    bitvectors and the index of its k-mers by hash: (start [4^k + 1],
    candidate, position), by (hash, candidate, position)."""

    def __init__(self, reads: _Reads, units: np.ndarray, read_of: np.ndarray,
                 k: int):
        rd = read_of[units]
        self.unit, self.lens = units, reads.lens[rd]
        self.count = reads.count[rd]
        self.strands = [(reads.bits[rd], self._index(reads, rd, k, False))]
        if reads.rbits is not None:
            self.strands.append((reads.rbits[rd],
                                 self._index(reads, rd, k, True)))

    @staticmethod
    def _index(reads: _Reads, rd: np.ndarray, k: int, rev: bool):
        h, cand, pos = _kmer_table(reads, rd, k, rev)
        cb = max(1, len(rd).bit_length())
        pb = max(1, int(reads.lens.max(initial=0)).bit_length())
        if 2 * k + cb + pb > 64:
            raise ValueError("reads too long or too many for the sort key")
        key = (h.astype(np.uint64) << np.uint64(cb + pb)) | (
            cand.astype(np.uint64) << np.uint64(pb)) | pos.astype(np.uint64)
        key.sort()
        start = np.zeros((1 << 2 * k) + 1, np.int64)
        np.cumsum(np.bincount(h, minlength=1 << 2 * k), out=start[1:])
        return (start,
                ((key >> np.uint64(pb)) & np.uint64((1 << cb) - 1)).astype(
                    np.int32),
                (key & np.uint64((1 << pb) - 1)).astype(np.int32))


class Reference:
    """The clustering of one read set (length-sorted, as main.cpp:254 sorts),
    its pairs decided by ``workers`` threads (default: ``share_of_cores``)."""

    def __init__(self, seqs: Sequence[str], p: Params, workers: int = 0):
        self.p = p
        self.workers = workers or share_of_cores()
        k = p.kmer_size
        if k > MAX_K:
            raise ValueError(f"k = {k}: the reference indexes k <= {MAX_K}")
        self.seqs = seqs
        self.n = len(seqs)
        self.lens = np.array([len(s) for s in seqs], np.int64)
        if self.n and self.lens.min() <= max(k, BV_KMER):
            raise ValueError("a read is too short for k")

    # -- one block's decisions ---------------------------------------------

    def _decide(self, pool, shares: List[_Share], seeds: np.ndarray,
                read_of: np.ndarray, free: np.ndarray, thr: float):
        """The matches of the units ``seeds`` among the free units after each
        (``free``), as cluster_together (cluster.cpp:12-65) decides at
        ``thr``: (seed's place in ``seeds``, unit, reverse), by the first
        two."""
        rd = read_of[seeds]
        c, at = _gather(self.reads.codes, self.reads.off, rd)
        h, read, pos = _kmers(c, at, self.p.kmer_size)
        q_off = np.zeros(len(seeds) + 1, np.int64)
        np.cumsum(np.bincount(read, minlength=len(seeds)), out=q_off[1:])
        query = (q_off, h.astype(np.int32), pos.astype(np.int32),
                 self.reads.bits[rd], self.reads.count[rd], self.lens[rd])
        found = list(pool.map(
            lambda sh: self._decide_share(sh, seeds, query, free, thr),
            shares))
        b, unit, rev = (np.concatenate(x) for x in zip(*found))
        order = np.lexsort((unit, b))
        return b[order], unit[order], rev[order]

    def _decide_share(self, sh: _Share, seeds, query, free, thr):
        p = self.p
        q_off, q_hash, q_pos, q_bits, q_count, q_lens = query
        after = (sh.unit[None, :] > seeds[:, None]) & free[sh.unit][None, :]
        out = np.zeros(after.shape, np.int8)
        lib = _lib()
        for strand, (bits, (start, e_cand, e_pos)) in enumerate(sh.strands):
            cand = (after & (out == 0)).view(np.uint8)
            if thr != 0:
                lib.gate(len(seeds), len(sh.unit), q_bits, q_count, bits,
                         sh.count, thr, cand)
            if lib.decide(len(seeds), len(sh.unit), q_off, q_hash, q_pos,
                          q_lens, start, e_cand, e_pos, sh.lens, p.kmer_size,
                          p.match_cap, p.t_s, p.t_v, cand):
                raise MemoryError("decide: out of memory")
            out[cand.view(bool)] = strand + 1
        b, j = np.nonzero(out)
        return b, sh.unit[j], out[b, j] == 2

    # -- the greedy pass and merge rounds --------------------------------

    def _shares(self, pool, units: np.ndarray, read_of: np.ndarray):
        deal = [units[i::self.workers] for i in range(self.workers)]
        return list(pool.map(
            lambda u: _Share(self.reads, u, read_of, self.p.kmer_size),
            [u for u in deal if len(u)]))

    def _walk(self, pool, read_of: np.ndarray, thr: float):
        """One pass of seeds over the units whose reads are ``read_of`` (reads
        in the greedy pass, clusters' main reads in a merge round): each unit
        not yet taken seeds a group of itself and every later free unit whose
        read it matches.  Returns [(seed, [(unit, rev)])]."""
        taken = np.zeros(len(read_of), bool)
        groups = []
        shares, dealt = [], 0
        size = BLOCK_SEEDS[0]
        pos = 0
        while True:
            ahead = np.flatnonzero(~taken[pos:]) + pos
            if not len(ahead):
                return groups
            pos = int(ahead[0])
            # deal the units ahead anew once under half of those dealt are
            # still free and ahead: the shares' dead weight stays below half
            if 2 * (len(ahead) - 1) < dealt or not shares:
                shares = self._shares(pool, ahead[1:], read_of)
                dealt = len(ahead) - 1
            blk = ahead[:size]
            hb, hu, hrev = (self._decide(pool, shares, blk, read_of, ~taken,
                                         thr) if shares else
                            (np.zeros(0, np.int64),) * 3)
            bounds = np.searchsorted(hb, np.arange(len(blk) + 1))
            seeded = 0
            for bi, u in enumerate(blk.tolist()):
                if taken[u]:
                    continue
                seeded += 1
                taken[u] = True
                js = hu[bounds[bi]:bounds[bi + 1]]
                revs = hrev[bounds[bi]:bounds[bi + 1]]
                ok = ~taken[js]
                js, revs = js[ok], revs[ok]
                taken[js] = True
                groups.append((u, list(zip(js.tolist(), revs.tolist()))))
            size = min(max(2 * seeded, BLOCK_SEEDS[0]), BLOCK_SEEDS[1])

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
        with ThreadPoolExecutor(self.workers) as pool:
            self.reads = _Reads(self.seqs, not self.p.rna, pool)
            for seed, hits in self._walk(pool, np.arange(self.n),
                                         self.p.bv_start):
                seqs = [(seed, False)] + hits
                clusters.append((self._main_seq(seqs), seqs))
            for thr in schedule(self.p):
                merged = []
                mains = np.array([c[0][0] for c in clusters], np.int64)
                for seed, hits in self._walk(pool, mains, thr):
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
