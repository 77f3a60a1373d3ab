# Copied from rattle_tpu/ops/encode.py.
"""Base encoding, reverse complement, and 2-bit packing.

Reference semantics: base code map A=0, C=1, T/U=2, G=3 (kmer.hpp:25-31);
complements A<->T, C<->G, U->A (utils.hpp:8-14).  In code space the complement
is ``code ^ 2`` (0<->2, 1<->3).
"""

from __future__ import annotations

import numpy as np

# char -> 2-bit code; unknown chars map to code 0 but are flagged by VALID.
BASE_TO_CODE = np.zeros(256, dtype=np.uint8)
BASE_VALID = np.zeros(256, dtype=bool)
for _ch, _code in (("A", 0), ("C", 1), ("T", 2), ("U", 2), ("G", 3)):
    BASE_TO_CODE[ord(_ch)] = _code
    BASE_VALID[ord(_ch)] = True

CODE_TO_BASE = np.frombuffer(b"ACTG", dtype=np.uint8)

_COMP_TABLE = np.zeros(256, dtype=np.uint8)
for _i in range(256):
    _COMP_TABLE[_i] = ord("N")
for _a, _b in (("A", "T"), ("C", "G"), ("T", "A"), ("G", "C"), ("U", "A")):
    _COMP_TABLE[ord(_a)] = ord(_b)


def encode_seq(seq: str) -> np.ndarray:
    """ACGTU string -> uint8 code array (A=0 C=1 T/U=2 G=3)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BASE_TO_CODE[raw]


def decode_seq(codes: np.ndarray) -> str:
    return CODE_TO_BASE[codes].tobytes().decode("ascii")


def reverse_complement_str(seq: str) -> str:
    """String-level reverse complement (utils.cpp:15-24); U -> A."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_TABLE[raw][::-1].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Code-space reverse complement: reverse then XOR 2."""
    return codes[::-1] ^ 2


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling 2-bit hash of every k-mer (kmer.hpp:33-40: big-endian shift).

    Returns hashes for ALL L-k+1 positions; callers slice to the reference's
    quirky position ranges (kmer.cpp:17-37 excludes the final position).
    """
    length = len(codes)
    if length < k:
        return np.zeros(0, dtype=np.uint32)
    c = codes.astype(np.uint64)
    # prefix[i] = value of codes[0:i] as base-4 number (mod 2^64)
    powers = np.zeros(length + 1, dtype=np.uint64)
    powers[0] = np.uint64(0)
    acc = np.uint64(0)
    # vectorized: h[i] = sum_{t<k} code[i+t] * 4^(k-1-t)
    out = np.zeros(length - k + 1, dtype=np.uint64)
    for t in range(k):
        out += c[t : t + length - k + 1] << np.uint64(2 * (k - 1 - t))
    del powers, acc
    return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def pack_2bit(codes: np.ndarray, width_u32: int) -> np.ndarray:
    """Pack codes into uint32 words, 16 bases per word, LSB-first."""
    length = len(codes)
    padded = np.zeros(width_u32 * 16, dtype=np.uint32)
    padded[:length] = codes
    padded = padded.reshape(width_u32, 16)
    shifts = (np.arange(16, dtype=np.uint32) * 2).astype(np.uint32)
    return (padded << shifts).sum(axis=1, dtype=np.uint32)
