# Copied from rattle_tpu/utils/phred.py.
"""Phred quality math (reference utils.cpp:6-13)."""

from __future__ import annotations

import math


def phred_err(c: str | int) -> float:
    """Error probability of a quality char: 10^(-(c-33)/10) (utils.cpp:10-13)."""
    q = (ord(c) if isinstance(c, str) else c) - 33
    return math.pow(10.0, -q / 10.0)


def phred_symbol(p: float) -> str:
    """Quality char of an error probability (utils.cpp:6-8).

    The reference computes ``char(-10*log10(p) + 33)``: the double is truncated
    toward zero by the implicit conversion to char.
    """
    return chr(int(-10.0 * math.log10(p) + 33.0))
