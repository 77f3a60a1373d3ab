"""The plain reference of RATTLE's ``correct`` step (correct.cpp:311-563), on
the clusters of a sample, in queue order (cluster, then pack: one of the
schedules RATTLE's work queue may take).

For each cluster, in the order of ``clusters.out``:

* packs (correct.cpp:328-370): the members' reads, each header given
  ``,gene_cluster_<cid>``, dealt round robin into ceil(n / split) packs; a
  pack of at most ``min_reads`` reads goes to ``uncorrected.fq`` as it is;
* each pack (correct.cpp:393-469): the MSA of its reads (``poa_ref.c``),
  the ends trimmed (``fix_msa_ends``, :32-92), each read corrected against
  the columns' consensus (``correct_read_pack``, :196-309, with
  ``generate_consensus_vector``, :94-193); the corrected reads, longest
  first, aligned again and trimmed, and their consensus is the pack's;
* the cluster's consensus (:488-556): a lone pack's, or the consensus of the
  MSA of its packs' consensi, trimmed; quality ``K`` throughout.

The POA is plain scalar C (``poa_ref.c``, built and loaded by
``native.load``), called through ctypes, which lets other threads run; a
pool of threads runs the packs.
Nothing here imports the program.
"""

from __future__ import annotations

import ctypes
import math
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import native

GAP = ord("-")
# the letters a column counts, in the order RATTLE's std::unordered_map
# yields them (correct.cpp:105-110); the first strict maximum is the
# column's consensus
LETTERS = b"U-GTCA"
TRIM_GAP_RUN = 4        # a block ends at this many gaps in a row (:45)
TRIM_SMALL_BLOCK = 10   # a block of fewer bases ... (:55)
TRIM_LARGE_GAP = 20     # ... followed by this many gaps is trimmed (:62)
CONSENSUS_QUALITY = "K"
ERR_RATIO = 30.0        # the substitution's error ratio (main.cpp:405)
_BASE = re.compile(rb"[^-]")

def _declare(lib: ctypes.CDLL) -> None:
    lib.poa_msa.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_int)]
    lib.poa_msa.restype = ctypes.c_int
    lib.poa_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.poa_free.restype = None


def _lib() -> ctypes.CDLL:
    return native.load("poa_ref.c", _declare)


def msa(seqs: Sequence[bytes], tiebreak_ef: bool = False) -> List[bytearray]:
    """The MSA rows of ``seqs``, aligned in their order (poa_ref.c)."""
    if not seqs:
        return []
    lib = _lib()
    lens = (ctypes.c_int * len(seqs))(*[len(s) for s in seqs])
    out = ctypes.POINTER(ctypes.c_char)()
    ncols = ctypes.c_int()
    rc = lib.poa_msa(len(seqs), b"".join(seqs), lens, int(tiebreak_ef),
                     ctypes.byref(out), ctypes.byref(ncols))
    if rc:
        raise RuntimeError(f"poa_msa failed ({rc}) on {len(seqs)} reads")
    try:
        flat = ctypes.string_at(out, len(seqs) * ncols.value)
    finally:
        lib.poa_free(out)
    w = ncols.value
    return [bytearray(flat[i * w:(i + 1) * w]) for i in range(len(seqs))]


@dataclass
class Record:
    """A fastq record: header line (with its ``@``), bases, qualities."""

    header: str
    seq: bytes
    qual: bytes

    def fastq(self) -> bytes:
        return b"%s\n%s\n+\n%s\n" % (self.header.encode(), self.seq,
                                     self.qual)


# ---- the MSA's ends (correct.cpp:32-92) ----

def _trim_front(row: bytearray) -> Tuple[int, bool]:
    """Blank, from the front of one row, each block of fewer than 10 bases
    (bases apart by fewer than 4 gaps) that 20 gaps or more follow.
    Returns (bases blanked, whether a block was kept)."""
    n, dropped = len(row), 0
    m = _BASE.search(row)
    while m:
        last, size = m.start(), 1
        nxt = _BASE.search(row, last + 1)
        while nxt and nxt.start() - last - 1 < TRIM_GAP_RUN:
            last, size = nxt.start(), size + 1
            nxt = _BASE.search(row, last + 1)
        end = nxt.start() if nxt else n
        if size >= TRIM_SMALL_BLOCK or end - last - 1 < TRIM_LARGE_GAP:
            return dropped, True
        row[m.start():end] = b"-" * (end - m.start())
        dropped += size
        m = nxt
    return dropped, False


def fix_msa_ends(rows: List[bytearray], reads: List[Record]) -> None:
    """Trim both ends of every row and its read in place: the front, then
    (the row and its read reversed) the back.  Where the front's scan leaves
    no block the back is not scanned; where the back's does, the row, which
    then holds no base, stays reversed, as RATTLE leaves it."""
    for row, rd in zip(rows, reads):
        seq, qual = bytearray(rd.seq), bytearray(rd.qual)
        for _end in range(2):
            dropped, kept = _trim_front(row)
            del seq[:dropped]
            del qual[:dropped]
            if not kept:
                break
            row.reverse()
            seq.reverse()
            qual.reverse()
        rd.seq, rd.qual = bytes(seq), bytes(qual)


# ---- the columns' consensus (correct.cpp:94-193) ----

class Columns:
    """An MSA's columns: each read's window (its first base to its last),
    each cell's quality, and, counting the letters within the windows, the
    consensus letter (the first strict maximum in ``LETTERS``' order, '-'
    where nothing counts), its count and the column's total."""

    def __init__(self, rows: List[bytearray], reads: List[Record]):
        self.mat = np.frombuffer(b"".join(rows), np.uint8).reshape(
            len(rows), -1)
        n, w = self.mat.shape
        base = self.mat != GAP
        lens = base.sum(axis=1)
        if any(int(k) != len(r.qual) for k, r in zip(lens, reads)):
            raise ValueError("an MSA row and its read differ in length")
        first = np.where(lens > 0, base.argmax(axis=1), w)
        last = w - 1 - base[:, ::-1].argmax(axis=1)
        at = np.arange(w)
        self.window = (at >= first[:, None]) & (at <= last[:, None])
        self.quals = np.zeros((n, w), np.uint8)
        self.quals[base] = np.frombuffer(b"".join(r.qual for r in reads),
                                         np.uint8)
        self.cons = np.full(w, GAP, np.uint8)
        self.cons_count = np.zeros(w, np.int64)
        self.total = np.zeros(w, np.int64)
        for letter in LETTERS:
            count = ((self.mat == letter) & self.window).sum(axis=0)
            self.total += count
            better = count > self.cons_count
            self.cons[better] = letter
            self.cons_count[better] = count[better]

    def consensus(self) -> bytes:
        return self.cons[self.cons != GAP].tobytes()

    def consensus_error(self, ft=np.float64) -> np.ndarray:
        """Mean error probability of the consensus letter's bases in each
        column (0 where the consensus is '-'), summed read by read, in the
        float type ``ft``."""
        err = _ERR[self.quals].astype(ft)
        is_cons = (self.mat == self.cons[None, :]) & self.window \
            & (self.cons != GAP)[None, :]
        acc = np.zeros(self.mat.shape[1], ft)
        for i in range(self.mat.shape[0]):
            acc = acc + np.where(is_cons[i], err[i], ft(0))
        return np.where(self.cons_count > 0,
                        acc / np.maximum(self.cons_count, 1).astype(ft),
                        ft(0)).astype(ft)


def _phred_err(q: int) -> float:
    return math.pow(10.0, -(q - 33) / 10.0)


_ERR = np.array([_phred_err(q) for q in range(256)])


def _symbol(p, ft=np.float64) -> int:
    """The quality letter of an error probability, truncated as C++'s
    conversion of -10 log10(p) + 33 to char does (utils.cpp:6-8), in the
    float type ``ft``."""
    if p <= 0:
        return ord("!")
    if ft is np.float64:
        return int(-10.0 * math.log10(p) + 33.0)
    return int(ft(-10.0) * np.log10(ft(p)) + ft(33.0))


def correct_pack(rows: List[bytearray], reads: List[Record],
                 p: dict) -> Tuple[List[Record], List[Record]]:
    """Each read against its pack's consensus (correct.cpp:219-283), cell by
    cell in its window: a base where the consensus has a gap is dropped,
    and a gap where it has a base filled, when the consensus letter's share
    of the column is gap_occ or more; a base unlike the consensus becomes
    the consensus's when its share is min_occ or more and err_ratio times
    the base's error is above the consensus's mean error.  A filled or
    replaced base takes the consensus's quality.  The error arithmetic is
    in ``p["float"]`` (RATTLE's: float64).  Returns (corrected, uncorrected:
    the reads left with no base)."""
    col = Columns(rows, reads)
    mat, win = col.mat, col.window
    with np.errstate(invalid="ignore", divide="ignore"):
        share = col.cons_count / col.total
    cons_gap = (col.cons == GAP)[None, :]
    nt_gap = mat == GAP
    ft = p["float"]
    err = col.consensus_error(ft)
    sym = np.array([_symbol(e, ft) for e in err], np.uint8)
    own_err = _ERR[col.quals].astype(ft)

    drop = win & cons_gap & ~nt_gap & (share >= p["gap_occ"])[None, :]
    fill = win & ~cons_gap & nt_gap & (share >= p["gap_occ"])[None, :]
    swap = (win & ~cons_gap & ~nt_gap & (mat != col.cons[None, :])
            & (share >= p["min_occ"])[None, :]
            & (ft(p["err_ratio"]) * own_err > err[None, :]))
    take = fill | swap
    emit = (win & ~nt_gap & ~drop) | fill
    out_seq = np.where(take, col.cons[None, :], mat)
    out_qual = np.where(take, sym[None, :], col.quals)
    corrected, uncorrected = [], []
    for i, rd in enumerate(reads):
        keep = emit[i]
        if keep.any():
            corrected.append(Record(rd.header, out_seq[i][keep].tobytes(),
                                    out_qual[i][keep].tobytes()))
        else:
            uncorrected.append(rd)
    return corrected, uncorrected


def pack_outcome(reads: List[Record], p: dict, ef: bool
                 ) -> Tuple[List[Record], List[Record], bytes]:
    """One pack's two rounds (correct.cpp:393-469): (corrected,
    uncorrected, the pack's consensus)."""
    reads = [Record(r.header, r.seq, r.qual) for r in reads]
    rows = msa([r.seq for r in reads], ef)
    fix_msa_ends(rows, reads)
    corrected, uncorrected = correct_pack(rows, reads, p)
    second = sorted((Record(r.header, r.seq, r.qual) for r in corrected),
                    key=lambda r: -len(r.seq))
    rows2 = msa([r.seq for r in second], ef)
    fix_msa_ends(rows2, second)
    cons = Columns(rows2, second).consensus() if second else b""
    return corrected, uncorrected, cons


def cluster_consensus(consensi: List[bytes], ef: bool) -> bytes:
    """The consensus of a cluster's pack consensi (correct.cpp:519-543)."""
    if len(consensi) == 1:
        return consensi[0]
    recs = [Record("", c, CONSENSUS_QUALITY.encode() * len(c))
            for c in consensi]
    rows = msa([r.seq for r in recs], ef)
    fix_msa_ends(rows, recs)
    return Columns(rows, recs).consensus()


# ---- a job's clusters ----

def split_packs(members: List[Record], split: int) -> List[List[Record]]:
    """Round robin into ceil(n / split) packs (correct.cpp:331-358)."""
    n_packs = (len(members) - 1) // split + 1
    return [members[q::n_packs] for q in range(n_packs)]


def _cost(pack: List[Record]) -> int:
    return len(pack) ** 2 * max(len(r.seq) for r in pack) ** 2


def correct_clusters(clusters: Dict[int, List[Record]], p: dict,
                     threads: int, ef: bool = False
                     ) -> Dict[int, Tuple[List[List[Record]],
                                          List[List[Record]],
                                          List[Record], Optional[bytes]]]:
    """Every cluster of ``clusters`` (cid -> its members' records, headers
    already given their cluster): per cid (each corrected pack's corrected
    reads, each corrected pack's uncorrected reads, the reads of the packs
    too small to correct, the cluster's consensus or None)."""
    packs = {cid: split_packs(m, p["split"]) for cid, m in clusters.items()}
    work = [(cid, q) for cid, pk in packs.items()
            for q, pack in enumerate(pk) if len(pack) > p["min_reads"]]
    work.sort(key=lambda cq: -_cost(packs[cq[0]][cq[1]]))
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        futs = {cq: pool.submit(pack_outcome, packs[cq[0]][cq[1]], p, ef)
                for cq in work}
        done = {cq: f.result() for cq, f in futs.items()}
        ran = {cid: [q for q in range(len(pk)) if (cid, q) in done]
               for cid, pk in packs.items()}
        multi = {cid: pool.submit(cluster_consensus,
                                  [done[(cid, q)][2] for q in qs], ef)
                 for cid, qs in ran.items() if qs}
        cons = {cid: f.result() for cid, f in multi.items()}
    out = {}
    for cid, pk in packs.items():
        small = [r for q, pack in enumerate(pk) if (cid, q) not in done
                 for r in pack]
        out[cid] = ([done[(cid, q)][0] for q in ran[cid]],
                    [done[(cid, q)][1] for q in ran[cid]], small,
                    cons.get(cid))
    return out
