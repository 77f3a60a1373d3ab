# Copied from rattle_tpu/ops/gates.py.
"""Integer-exact threshold tables.

The reference evaluates its gates with double-precision divisions of integer
quantities (cluster.cpp:17-19, 24-32).  TPUs have no fp64, so instead of
reproducing the division on device we precompute, per integer denominator, the
minimal integer numerator that passes — turning every gate into an exact int32
comparison on device:

* bv gate:    bv_common/mmax     >= thr   ->  bv_common >= bv_min_table[mmax]
* score gate: bases/min_len      >= t_s   ->  bases     >= score_min_table[mn]

The tables are built with numpy float64, which is bit-identical to C++ double.
"""

from __future__ import annotations

import numpy as np

INT32_MAX = 2**31 - 1


def min_numerator_table(max_denom: int, threshold: float) -> np.ndarray:
    """t[m] = smallest integer c with float64(c)/float64(m) >= threshold.

    t[0] = INT32_MAX: the reference's 0/0 is NaN which fails ``>=`` (only
    reachable through the reverse-strand gate; forward has an explicit
    threshold==0 bypass which callers encode as an all-zero table).
    """
    if threshold <= 0.0:
        return np.zeros(max_denom + 1, dtype=np.int32)
    m = np.arange(1, max_denom + 1, dtype=np.float64)
    c = np.ceil(m * threshold)
    # correct the guess by one in either direction (fp64 rounding safety)
    c = np.where((c - 1.0) / m >= threshold, c - 1.0, c)
    c = np.where(c / m < threshold, c + 1.0, c)
    assert np.all(c / m >= threshold)
    assert np.all((c - 1.0) / m < threshold)
    table = np.empty(max_denom + 1, dtype=np.int32)
    table[0] = INT32_MAX
    table[1:] = c.astype(np.int64).clip(0, INT32_MAX)
    return table
