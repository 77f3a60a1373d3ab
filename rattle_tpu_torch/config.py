# Copied from rattle_tpu/config.py.
"""All pipeline parameters in one place.

Every reference flag (main.cpp:134-179, 326-349, 613-630) plus every
hard-coded constant (SURVEY §5 "Config / flag system") is a field here, with
reference defaults preserved.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List


@dataclass(frozen=True)
class ClusterParams:
    """Gene/isoform clustering parameters (main.cpp:200-218)."""

    kmer_size: int = 10           # -k (default 10, max 16)
    t_s: float = 0.2              # -s score threshold
    t_v: float = 1000000.0        # -v max LIS-gap variance
    bv_threshold: float = 0.4     # -B bitvector start threshold
    bv_min_threshold: float = 0.2  # -b bitvector end threshold
    bv_falloff: float = 0.05      # -f per-round falloff
    min_reads_cluster: int = 0    # -r
    repr_percentile: float = 0.15  # -p representative percentile
    use_hc: bool = False          # hc_bases instead of bases (never a flag)
    is_rna: bool = False          # --rna: skip reverse-strand checks

    # constants the reference hard-codes
    bv_kmer_size: int = 6         # kmer.hpp:14 KMER_BV_SIZE
    hc_max_dist: int = 10         # similarity.cpp:73 gap-diff < 10 => high conf


ISO_CLUSTER_DEFAULTS = ClusterParams(kmer_size=11, t_s=0.3, t_v=25.0)

# polish re-clusters consensi with these exact hard-coded params (main.cpp:669)
POLISH_CLUSTER_PARAMS = ClusterParams(
    kmer_size=6, t_s=0.5, t_v=25.0, bv_threshold=0.4, bv_min_threshold=0.4,
    bv_falloff=0.05, min_reads_cluster=0, repr_percentile=0.15, use_hc=False,
)


@dataclass(frozen=True)
class CorrectParams:
    """Correction parameters (main.cpp:396-405)."""

    min_occ: float = 0.3          # -m
    gap_occ: float = 0.3          # -g
    err_ratio: float = 30.0       # hard-coded at main.cpp:405
    split: int = 200              # -s max reads per MSA pack
    min_reads: int = 5            # -r min reads to correct a pack

    # POA scoring, hard-coded at correct.cpp:395-396 (spoa local/SW mode)
    poa_match: int = 5
    poa_mismatch: int = -4
    poa_gap_open: int = -8
    poa_gap_extend: int = -6

    # MSA end-trim constants (correct.cpp:45,55,62)
    trim_gap_run: int = 4         # gaps that terminate a block
    trim_small_block: int = 10    # blocks shorter than this are candidates
    trim_large_gap: int = 20      # following gap run that triggers deletion

    consensus_quality: str = "K"  # correct.cpp:469,540 constant quality


# polish re-corrects with these exact hard-coded params (main.cpp:670)
POLISH_CORRECT_PARAMS = CorrectParams(min_occ=0.3, gap_occ=0.3, err_ratio=30.0,
                                      split=200, min_reads=0)


@dataclass(frozen=True)
class InputParams:
    """Read filtering (main.cpp:217-218)."""

    raw: bool = False             # --raw: skip the length window
    lower_len: int = 150          # --lower-length
    upper_len: int = 100000       # --upper-length


@dataclass(frozen=True)
class RunConfig:
    cluster: ClusterParams = field(default_factory=ClusterParams)
    iso_cluster: ClusterParams = field(default_factory=lambda: ISO_CLUSTER_DEFAULTS)
    correct: CorrectParams = field(default_factory=CorrectParams)
    inputs: InputParams = field(default_factory=InputParams)
    labels: List[str] = field(default_factory=list)
    verbose: bool = False


def bv_threshold_schedule(p: ClusterParams) -> List[float]:
    """The merge-round threshold schedule (cluster.cpp:171-256).

    Starts at B - f and steps down by f while >= b, then one final round at
    exactly 0.0.  Reproduces the reference's floating-point accumulation so
    borderline bitvector-score comparisons match bit for bit.  Quirk: if the
    very first value B - f is already below b the loop never executes, so
    there are NO merge rounds at all (not even the 0.0 one) — this is what
    polish mode hits with its hard-coded B == b == 0.4 (main.cpp:669).
    """
    schedule: List[float] = []
    current = p.bv_threshold - p.bv_falloff
    if current < p.bv_min_threshold:
        return schedule
    while current >= p.bv_min_threshold:
        schedule.append(current)
        current -= p.bv_falloff
    schedule.append(0.0)
    return schedule


__all__ = [
    "ClusterParams", "CorrectParams", "InputParams", "RunConfig",
    "ISO_CLUSTER_DEFAULTS", "POLISH_CLUSTER_PARAMS", "POLISH_CORRECT_PARAMS",
    "bv_threshold_schedule", "replace",
]
