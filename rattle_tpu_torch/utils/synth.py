"""Synthetic Nanopore-like reads from a seed, for runs without a real input.

Families are random transcripts of ``lo``..``hi`` bp; family sizes follow a
Zipf-like expression profile; every read is a full-length copy with ``err``
noise per base (35% deletions, 30% insertions, 35% substitutions, the mix of
tests/conftest.py's ``mutate``), vectorised so 8,192 reads of 300-3,000 bp
take about a second.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the main path's input on the card: the toyset's scale (8,306 reads, 546
# gene clusters); chip_smoke.py and pipeline/profile_cluster.py both use it
MAIN_READS = 8192
MAIN_FAMILIES = 550
MAIN_SEED = 2024

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_BASES] = np.frombuffer(b"TGCA", np.uint8)


def mutate(rng: np.random.Generator, ref: np.ndarray, err: float
           ) -> np.ndarray:
    """A noisy copy of the base array ``ref``."""
    r = rng.random(len(ref))
    sub = (r >= 0.65 * err) & (r < err)
    base = np.where(sub, rng.choice(_BASES, len(ref)), ref)
    kept = r >= 0.35 * err
    counts = kept.astype(np.int64) + (kept & (r < 0.65 * err))
    out = base[np.repeat(np.arange(len(ref)), counts)]
    ins_at = (np.cumsum(counts) - counts)[counts == 2]
    out[ins_at] = rng.choice(_BASES, len(ins_at))
    return out


def synthetic_reads(n_reads: int, n_families: int, seed: int,
                    revcomp: bool = False, lo: int = 300, hi: int = 3000,
                    err: float = 0.08) -> List[Tuple[str, str, int]]:
    """[(name, seq, family)]; with ``revcomp`` half the reads are
    reverse-complemented (cDNA)."""
    rng = np.random.default_rng(seed)
    refs = [rng.choice(_BASES, int(rng.integers(lo, hi + 1)))
            for _ in range(n_families)]
    weights = 1.0 / np.arange(1, n_families + 1) ** 0.8
    fams = np.sort(rng.choice(n_families, n_reads, p=weights / weights.sum()))
    out = []
    for i, f in enumerate(fams):
        s = mutate(rng, refs[f], err)
        if revcomp and rng.random() < 0.5:
            s = _COMP[s][::-1]
        out.append((f"read{i}_fam{f}", s.tobytes().decode("ascii"), int(f)))
    return out


def write_fastq(reads, path: str) -> None:
    with open(path, "w") as fh:
        for name, seq, _f in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
