# Frozen from rattle_tpu_torch/utils/synth.py (mutate, synthetic_reads, write_fastq); the sizes fixed, the exponent a parameter.
"""Synthetic Nanopore-like reads of one deployment, from a seed.

Genes are random transcripts; every read is a full-length copy of one with
``err`` noise per base (35% deletions, 30% insertions, 35% substitutions).

Every seed gives the same sizes, so that every seed asks the same work of the
program: gene g (by rank) has a length spread evenly over ``lo``..``hi`` by
the golden-ratio sequence and the largest-remainder share of ``n_reads`` of
its weight 1 / (g + 1) ** ``exponent`` (0: flat expression).  The seed draws
the bases, the noise, which ``revcomp`` share of the reads is
reverse-complemented (cDNA), and the order of the reads in the file.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_BASES] = np.frombuffer(b"TGCA", np.uint8)
_GOLDEN = (5 ** 0.5 - 1) / 2


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


def gene_sizes(n_reads: int, n_genes: int, exponent: float, lo: int, hi: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(reads a gene, transcript length a gene), the same for every seed."""
    w = 1.0 / np.arange(1, n_genes + 1) ** exponent
    share = n_reads * w / w.sum()
    reads = np.floor(share).astype(np.int64)
    rest = n_reads - int(reads.sum())
    reads[np.argsort(-(share - reads), kind="stable")[:rest]] += 1
    frac = (np.arange(n_genes) * _GOLDEN) % 1.0
    lengths = lo + np.round(frac * (hi - lo)).astype(np.int64)
    return reads, lengths


def synthetic_reads(n_reads: int, n_genes: int, seed, exponent: float = 0.8,
                    revcomp: float = 0.0, lo: int = 300, hi: int = 3000,
                    err: float = 0.08) -> List[Tuple[str, str, int]]:
    """[(name, seq, gene)] in the file's order."""
    rng = np.random.default_rng(seed)
    reads_of, lengths = gene_sizes(n_reads, n_genes, exponent, lo, hi)
    refs = [rng.choice(_BASES, int(n)) for n in lengths]
    genes = np.repeat(np.arange(n_genes), reads_of)
    flip = np.zeros(n_reads, bool)
    flip[rng.permutation(n_reads)[:int(round(revcomp * n_reads))]] = True
    out = []
    for i in rng.permutation(n_reads):
        g = int(genes[i])
        s = mutate(rng, refs[g], err)
        if flip[i]:
            s = _COMP[s][::-1]
        out.append((f"read{len(out)}_gene{g}", s.tobytes().decode("ascii"), g))
    return out


def write_fastq(reads, path: str) -> None:
    with open(path, "w") as fh:
        for name, seq, _g in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
