# Copied from rattle_tpu/correct/consensus.py.
"""MSA end-trimming, consensus columns, and per-read correction rules.

Exact reimplementation of the reference's correction math:

* ``fix_msa_ends``              correct.cpp:32-92
* ``generate_consensus_vector`` correct.cpp:94-193
* ``correct_read_pack``         correct.cpp:196-309

Consensus tie-break: the reference takes the first strict maximum while
iterating a ``std::unordered_map<char, pos_info_t>``; with libstdc++ and the
insertion order of correct.cpp:105-110 that iteration order is
``U - G T C A`` (verified empirically), reproduced here.

Occupancy subtlety (correct.cpp:134-150): leading MSA gaps (before the read's
first base) and trailing gaps (after its last base) are NOT counted — only
internal gaps contribute to the '-' row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..io.fastx import Read
from ..utils.phred import phred_err, phred_symbol

NT_ORDER = "U-GTCA"  # unordered_map iteration order; first strict max wins
_NT_INDEX: Dict[str, int] = {c: i for i, c in enumerate(NT_ORDER)}
TRIM_GAP_RUN = 4
TRIM_SMALL_BLOCK = 10
TRIM_LARGE_GAP = 20

# precomputed phred error per char code
_PHRED_ERR = np.array([phred_err(c) for c in range(256)], dtype=np.float64)


def fix_msa_ends(reads: List[Read], aln: List[str]) -> None:
    """Trim noisy MSA ends in place (correct.cpp:32-92).

    Per row, from each end: a "small block" (< 10 nt, terminated by 4
    consecutive gaps) followed by >= 20 gaps is blanked from the MSA row and
    its bases erased from the front of seq+quality.  The second end is handled
    by reversing row+seq+quality and re-running; quirk preserved: if the scan
    consumes the whole row the strings are left reversed exactly as the
    reference leaves them.
    """
    for i in range(len(aln)):
        row = list(aln[i])
        seq = list(reads[i].seq)
        qual = list(reads[i].quality)
        reversed_once = False
        restart = True
        while restart:
            restart = False
            pos = 0
            n = len(row)
            while pos < n:
                while pos < n and row[pos] == "-":
                    pos += 1
                end_pos = pos
                gaps = 0
                sz = 0
                while gaps < TRIM_GAP_RUN and end_pos < n:
                    if row[end_pos] == "-":
                        gaps += 1
                    else:
                        sz += 1
                        gaps = 0
                    end_pos += 1
                if sz < TRIM_SMALL_BLOCK:
                    while end_pos < n and row[end_pos] == "-":
                        end_pos += 1
                        gaps += 1
                    if gaps >= TRIM_LARGE_GAP:
                        for j in range(pos, end_pos):
                            row[j] = "-"
                        del qual[:sz]
                        del seq[:sz]
                        pos = end_pos
                    else:
                        row.reverse()
                        qual.reverse()
                        seq.reverse()
                        if not reversed_once:
                            reversed_once = True
                            restart = True
                        break
                else:
                    row.reverse()
                    qual.reverse()
                    seq.reverse()
                    if not reversed_once:
                        reversed_once = True
                        restart = True
                    break
        aln[i] = "".join(row)
        reads[i].seq = "".join(seq)
        reads[i].quality = "".join(qual)


@dataclass
class ConsensusVector:
    """Per-column stats in NT_ORDER rows: occ, mean err, total_occ, consensus."""

    occ: np.ndarray        # [6, W] int64
    err: np.ndarray        # [6, W] float64 (mean error where occ > 0)
    total_occ: np.ndarray  # [W] int64
    consensus: np.ndarray  # [W] byte chars

    def consensus_string(self) -> str:
        """Consensus with gaps removed (correct.cpp:304-306)."""
        keep = self.consensus != ord("-")
        return self.consensus[keep].tobytes().decode("ascii")


def _msa_matrix(aln: List[str]) -> np.ndarray:
    return np.frombuffer("".join(aln).encode("ascii"), dtype=np.uint8).reshape(
        len(aln), -1)


def _occupancy_window(mat: np.ndarray, reads: List[Read]) -> Tuple[np.ndarray, np.ndarray]:
    """Per row: boolean window [start of first base .. last base] and the
    per-cell seq position (cumulative non-gap count - 1)."""
    nongap = mat != ord("-")
    cum = np.cumsum(nongap, axis=1)
    lens = np.array([len(r.quality) for r in reads])[:, None]
    window = (cum >= 1) & ((cum < lens) | ((cum == lens) & nongap))
    seq_pos = cum - 1
    return window, seq_pos


def generate_consensus_vector(reads: List[Read], aln: List[str]) -> ConsensusVector:
    if len(reads) == 0 or len(aln) == 0:
        z = np.zeros((6, 0), dtype=np.int64)
        return ConsensusVector(z, np.zeros((6, 0)), np.zeros(0, dtype=np.int64),
                               np.zeros(0, dtype=np.uint8))
    mat = _msa_matrix(aln)
    n, w = mat.shape
    window, seq_pos = _occupancy_window(mat, reads)

    qmat = np.zeros((n, w), dtype=np.uint8)
    for i, r in enumerate(reads):
        q = np.frombuffer(r.quality.encode("ascii"), dtype=np.uint8)
        sp = np.clip(seq_pos[i], 0, max(len(q) - 1, 0))
        if len(q):
            qmat[i] = q[sp]
    errs = _PHRED_ERR[qmat]

    occ = np.zeros((6, w), dtype=np.int64)
    errsum = np.zeros((6, w), dtype=np.float64)
    for row, ch in enumerate(NT_ORDER):
        sel = (mat == ord(ch)) & window
        occ[row] = sel.sum(axis=0)
        if ch != "-":
            errsum[row] = np.where(sel, errs, 0.0).sum(axis=0)

    total = occ.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        err_mean = np.where(occ > 0, errsum / np.maximum(occ, 1), 0.0)

    # first strict maximum in NT_ORDER; all-zero columns -> '-'
    best_row = np.argmax(occ, axis=0)  # argmax returns FIRST max in row order
    consensus = np.frombuffer(NT_ORDER.encode("ascii"), dtype=np.uint8)[best_row]
    consensus = np.where(occ.max(axis=0) > 0, consensus, ord("-")).astype(np.uint8)
    return ConsensusVector(occ, err_mean, total, consensus)


def correct_read_pack(reads: List[Read], aln: List[str], min_occ: float,
                      gap_occ: float, err_ratio: float
                      ) -> Tuple[List[Read], List[Read], ConsensusVector]:
    """Apply the per-read edit rules (correct.cpp:219-283).

    Returns (corrected, uncorrected, consensus_vector)."""
    cv = generate_consensus_vector(reads, aln)
    corrected: List[Read] = []
    uncorrected: List[Read] = []
    if cv.consensus.size == 0:
        return corrected, list(reads), cv

    mat = _msa_matrix(aln)
    window, seq_pos = _occupancy_window(mat, reads)
    cons_idx = np.array([_NT_INDEX[chr(c)] for c in cv.consensus])
    cons_occ = cv.occ[cons_idx, np.arange(mat.shape[1])]
    with np.errstate(invalid="ignore", divide="ignore"):
        occ_ratio = cons_occ.astype(np.float64) / cv.total_occ.astype(np.float64)
    cons_err = cv.err[cons_idx, np.arange(mat.shape[1])]
    cons_err_sym = np.array([ord(phred_symbol(e)) if e > 0 else ord("!")
                             for e in cons_err], dtype=np.uint8)

    gap = ord("-")
    for i, r in enumerate(reads):
        q = np.frombuffer(r.quality.encode("ascii"), dtype=np.uint8)
        s = np.frombuffer(r.seq.encode("ascii"), dtype=np.uint8)
        win = window[i]
        nt = mat[i]
        sp = np.clip(seq_pos[i], 0, max(len(q) - 1, 0))
        own_q = q[sp] if len(q) else np.zeros(mat.shape[1], np.uint8)
        own_s = s[sp] if len(s) else np.zeros(mat.shape[1], np.uint8)
        err_p = _PHRED_ERR[own_q]
        cons = cv.consensus

        is_gap_nt = nt == gap
        is_gap_cons = cons == gap
        # cell-wise action
        keep_own = np.zeros(mat.shape[1], bool)
        take_cons = np.zeros(mat.shape[1], bool)
        # consensus gap, read base: delete insertion if ratio passes, else keep
        m = win & is_gap_cons & ~is_gap_nt
        keep_own |= m & ~(occ_ratio >= gap_occ)
        # consensus base, read gap: fill deletion if ratio passes
        m = win & ~is_gap_cons & is_gap_nt
        take_cons |= m & (occ_ratio >= gap_occ)
        # both bases
        m = win & ~is_gap_cons & ~is_gap_nt
        same = m & (nt == cons)
        keep_own |= same
        diff = m & (nt != cons)
        sub = diff & (occ_ratio >= min_occ) & (err_ratio * err_p > cons_err)
        take_cons |= sub
        keep_own |= diff & ~sub

        out_len = int(keep_own.sum() + take_cons.sum())
        res_s = np.where(keep_own, own_s, np.where(take_cons, cons, 0))
        res_q = np.where(keep_own, own_q, np.where(take_cons, cons_err_sym, 0))
        sel = keep_own | take_cons
        res_read = res_s[sel].tobytes().decode("ascii")
        res_qt = res_q[sel].tobytes().decode("ascii")
        if out_len > 0:
            corrected.append(Read(r.header, res_read, "+", res_qt))
        else:
            uncorrected.append(r)
    return corrected, uncorrected, cv
