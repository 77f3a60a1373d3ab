"""Device-side k-mer sketch tables; port of rattle_tpu/ops/sketch_device.py.

  host:   2-bit-encode reads (~1 byte/base) -> one h2d copy of [N, L] uint8
  device: rolling k-mer hashes                                  kmer.hpp:33-40
          per-row stable sort by hash -> (hs, ps)               kmer.cpp:39-40
          6-mer presence bits, PACKED as [N, 128] int32 words   kmer.hpp:14-16
          set-bit counts bvc

Hashes are int64, so ``PAD_HASH = 0xFFFFFFFF`` sorts after every real hash
(k < 16) and a real k=16 hash equal to it still sorts before the pad slots,
whose positions are larger (stable sort).  The presence bits are stored
packed in ops/sketch.py ``_pack_bv`` order (bit h at word h >> 5, bit h & 31),
which is what the gate kernel reads.  Semantics are those of the host tables
of ops/sketch.build_sketch_tables: positions cover [0, L-k), 6-mers [0, L-6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve
from .encode import BASE_TO_CODE
from .sketch import BV_KMER, BV_SIZE, BV_WORDS, PAD_HASH

PAD = int(PAD_HASH)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class DeviceSketch:
    """Device-resident tables of N (padded) reads, n_real of them real."""

    hbp: torch.Tensor       # [N, K] int64, hash at each position
    hs: torch.Tensor        # [N, K] int64, sorted by (hash, pos)
    ps: torch.Tensor        # [N, K] int32, positions co-sorted with hs
    bvp: torch.Tensor       # [N, 128] int32 packed 6-mer presence words
    nk: torch.Tensor        # [N] int32
    lens: torch.Tensor      # [N] int32
    bvc: torch.Tensor       # [N] int32
    rev_hs: Optional[torch.Tensor] = None
    rev_ps: Optional[torch.Tensor] = None
    rev_bvp: Optional[torch.Tensor] = None
    n_real: int = 0
    kmer_size: int = 10

    @property
    def kmax(self) -> int:
        return self.hbp.shape[1]


def encode_batch(seqs: List[str], l_pad: int, n_pad: int) -> np.ndarray:
    """[n_pad, l_pad] uint8 code matrix (pad rows/tails are code 0)."""
    out = np.zeros((n_pad, l_pad), dtype=np.uint8)
    for i, s in enumerate(seqs):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
        out[i, : len(raw)] = BASE_TO_CODE[raw]
    return out


def pack_bits(plane: torch.Tensor) -> torch.Tensor:
    """[N, 4096] 0/1 plane -> [N, 128] int32 words (bit h at word h >> 5,
    bit h & 31; the int32 holds the uint32 word's two's complement)."""
    n = plane.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=plane.device)
    words = (plane.reshape(n, BV_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _rolling(c: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """Big-endian 2-bit rolling hash of the k-mer at each of ``width``
    positions (kmer.hpp:33-40), in int64 without masking."""
    h = torch.zeros((c.shape[0], width), dtype=torch.int64, device=c.device)
    for t in range(k):
        h = (h << 2) | c[:, t:t + width]
    return h


def _device_tables(codes: torch.Tensor, nk: torch.Tensor, lens: torch.Tensor,
                   k: int, kmax: int):
    """codes [N, kmax + k] uint8 -> (hbp, hs, ps, bvp, bvc)."""
    n, l_pad = codes.shape
    c = codes.to(torch.int64)
    mask = 0xFFFFFFFF if k >= 16 else (1 << (2 * k)) - 1
    h = _rolling(c, k, kmax) & mask
    pos = torch.arange(kmax, dtype=torch.int64, device=codes.device)[None, :]
    valid = pos < nk[:, None]
    hbp = torch.where(valid, h, PAD)
    # stable: equal hashes keep position order, and the pad slots (pos >= nk)
    # stay behind a real k=16 hash equal to PAD; zero them like the host
    hs, order = torch.sort(hbp, dim=1, stable=True)
    ps = torch.where(valid, order, 0).to(torch.int32)

    # 6-mer presence over [0, L-6) (kmer.cpp:30-37); every 6-mer start in
    # the padded code row is covered, L - 6 <= l_pad - 6
    w6 = l_pad - BV_KMER + 1
    h6 = _rolling(c, BV_KMER, w6) & (BV_SIZE - 1)
    pos6 = torch.arange(w6, dtype=torch.int64, device=codes.device)[None, :]
    h6 = torch.where(pos6 < (lens[:, None] - BV_KMER), h6, BV_SIZE)
    plane = torch.zeros((n, BV_SIZE + 1), dtype=torch.uint8,
                        device=codes.device)
    plane.scatter_(1, h6, 1)
    plane = plane[:, :BV_SIZE]
    bvc = plane.sum(dim=1, dtype=torch.int32)
    return hbp, hs, ps, pack_bits(plane), bvc


def _revcomp_codes_batch(codes: torch.Tensor, lens: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row reverse complement in code space (reverse first L, XOR 2)."""
    n, l = codes.shape
    j = torch.arange(l, dtype=torch.int64, device=codes.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - j
    rc = torch.gather(codes, 1, src.clamp(0, l - 1)) ^ 2
    return torch.where(src >= 0, rc, 0).to(torch.uint8)


def build_device_sketch(seqs: List[str], kmer_size: int, both_strands: bool,
                        kmax: Optional[int] = None, n_pad_to: int = 256,
                        device="cuda", n_pad: Optional[int] = None
                        ) -> DeviceSketch:
    """Build all tables on ``device``; one h2d transfer of the code matrix.
    The tables have ``n_pad`` rows (default: the read count rounded up to
    ``n_pad_to``); pad rows have nk = lens = 0 and no k-mers."""
    dev = resolve(device)
    n = len(seqs)
    lens_host = np.array([len(s) for s in seqs], dtype=np.int32)
    nk_host = (lens_host - kmer_size).astype(np.int32)
    if np.any(nk_host <= 0) or np.any(lens_host <= BV_KMER):
        bad = int(np.argmax(nk_host <= 0))
        raise ValueError(
            f"read {bad} too short (len {lens_host[bad]}) for k={kmer_size}")
    if kmax is None:
        kmax = _round_up(int(nk_host.max()), 128)
    if n_pad is None:
        n_pad = _round_up(n, n_pad_to)
    l_pad = kmax + kmer_size

    nk_p = np.zeros(n_pad, np.int32)
    nk_p[:n] = nk_host
    lens_p = np.zeros(n_pad, np.int32)
    lens_p[:n] = lens_host
    d_codes = torch.from_numpy(encode_batch(seqs, l_pad, n_pad)).to(dev)
    d_nk = torch.from_numpy(nk_p).to(dev)
    d_lens = torch.from_numpy(lens_p).to(dev)
    hbp, hs, ps, bvp, bvc = _device_tables(d_codes, d_nk, d_lens, kmer_size,
                                           kmax)
    sk = DeviceSketch(hbp=hbp, hs=hs, ps=ps, bvp=bvp, nk=d_nk, lens=d_lens,
                      bvc=bvc, n_real=n, kmer_size=kmer_size)
    if both_strands:
        rc = _revcomp_codes_batch(d_codes, d_lens)
        _, sk.rev_hs, sk.rev_ps, sk.rev_bvp, _ = _device_tables(
            rc, d_nk, d_lens, kmer_size, kmax)
    return sk


def build_device_sketch_sharded(local_seqs: List[str],
                                global_lens: np.ndarray, start: int,
                                rows: int, kmer_size: int,
                                both_strands: bool,
                                device="cuda") -> DeviceSketch:
    """One rank's rows of the sketch of a length-sorted read set.

    ``local_seqs`` are the reads of global rows [start, start + len), the
    rank's contiguous slice; the tables hold ``rows`` rows (the slice, then
    pad rows).  ``kmax`` is the one the full build takes over all reads,
    from ``global_lens``, which every rank knows, so the ranks' tables put
    together are the full build's, row for row.  No rank builds or holds
    another rank's rows."""
    if len(local_seqs) > rows:
        raise ValueError(f"{len(local_seqs)} reads for {rows} rows")
    own = np.asarray(global_lens[start:start + len(local_seqs)])
    if not np.array_equal(own, [len(s) for s in local_seqs]):
        raise ValueError(f"the reads are not global rows {start}..")
    kmax = _round_up(int(np.max(global_lens)) - kmer_size, 128)
    return build_device_sketch(list(local_seqs), kmer_size, both_strands,
                               kmax=kmax, device=device, n_pad=rows)


def sketch_from_numpy(hbp, hs, ps, plane, nk, lens, bvc, rev_hs=None,
                      rev_ps=None, rev_plane=None, kmer_size: int = 10,
                      device="cuda") -> DeviceSketch:
    """The port's sketch from tables built elsewhere, given as numpy arrays
    (the JAX DeviceSketch layout): uint32 hashes, int32 positions, UNPACKED
    int8 [N, 4096] presence planes.  Hashes widen to int64 and the planes
    pack to [N, 128] int32 words, so an engine can be held against another
    on identical tables."""
    dev = resolve(device)

    def hashes(a):
        return torch.from_numpy(
            np.asarray(a, np.uint32).astype(np.int64)).to(dev)

    def ints(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    def words(a):
        return pack_bits(torch.from_numpy(np.array(a, np.uint8)).to(dev))

    sk = DeviceSketch(hbp=hashes(hbp), hs=hashes(hs), ps=ints(ps),
                      bvp=words(plane), nk=ints(nk), lens=ints(lens),
                      bvc=ints(bvc), n_real=int(np.count_nonzero(nk)),
                      kmer_size=kmer_size)
    if rev_hs is not None:
        sk.rev_hs, sk.rev_ps = hashes(rev_hs), ints(rev_ps)
        sk.rev_bvp = words(rev_plane)
    return sk
