# Copied from rattle_tpu/utils/varmath.py.
"""Mean / sample variance exactly as the reference computes them.

Reference utils.cpp:26-55: compensated two-pass sample variance (Chan, Golub,
LeVeque eq. 1.7).  Quirks that matter for gate parity (cluster.cpp:34,58):

* ``var([])``  -> 0.0           (passes ``var < t_v``)
* ``var([x])`` -> 0.0/0.0 = NaN (fails ``var < t_v``)

Both are reproduced here, with the same sequential double-precision summation
order as the C++ loops.
"""

from __future__ import annotations

from typing import Sequence


def mean(s: Sequence[int]) -> float:
    res = 0.0
    for n in s:
        res += float(n)
    return res / float(len(s))


def var(s: Sequence[int]) -> float:
    if len(s) == 0:
        return 0.0
    ss = 0.0
    compensation = 0.0
    m = mean(s)
    for n in s:
        d = n - m
        ss += d * d
        compensation += d
    denom = float(len(s) - 1)
    num = ss - compensation * compensation / float(len(s))
    if denom == 0.0:
        return float("nan") if num == 0.0 else float("inf") * (1 if num > 0 else -1)
    return num / denom
