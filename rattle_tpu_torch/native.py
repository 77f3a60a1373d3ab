# Copied from rattle_tpu/native.py; the port builds its own library.
"""ctypes bindings for the native host runtime (native/rattle_native.cpp).

Everything here has a pure-Python/NumPy twin (ops/sketch.py, ops/poa.py); the
native path is a drop-in accelerator with identical semantics, verified by
tests/test_torch_native.py.  The port compiles ``native/rattle_native.cpp``
(read in place) with ``native/Makefile``'s flags into
``build/rattle_tpu_torch/librattle_native.so`` at first use and loads only
that library, never the ``native/librattle_native.so`` beside the source
(which may be older than it).  It rebuilds when the source is newer than the
library or its hash differs from the one recorded beside the library, under
a file lock, so that concurrent processes build once.  Without a compiler
callers fall back to the Python twins.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import List, Optional

import numpy as np

from ._ext import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "rattle_native.cpp")
SO = os.path.join(BUILD_DIR, "librattle_native.so")
# native/Makefile's flags, warnings aside
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lib = None


def _source_hash() -> str:
    with open(_SRC, "rb") as fh:
        return hashlib.sha256(fh.read() + " ".join(CXXFLAGS).encode()
                              ).hexdigest()


def _stale(digest: str) -> bool:
    try:
        with open(SO + ".sha256") as fh:
            recorded = fh.read().strip()
        return (recorded != digest
                or os.path.getmtime(_SRC) > os.path.getmtime(SO))
    except OSError:
        return True


def _build() -> None:
    """Compile the library into BUILD_DIR unless it is current; the build
    goes to a temporary name renamed into place, under a file lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _source_hash()
    with open(SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(digest):
            return
        tmp = f"{SO}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
                        _SRC], check=True, capture_output=True)
        os.replace(tmp, SO)
        with open(f"{SO}.sha256.{os.getpid()}.tmp", "w") as fh:
            fh.write(digest + "\n")
        os.replace(f"{SO}.sha256.{os.getpid()}.tmp", SO + ".sha256")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        _build()
        lib = ctypes.CDLL(SO)
    except (OSError, subprocess.CalledProcessError):
        return None

    i64 = ctypes.c_int64
    lib.rn_build_sketch.restype = None
    lib.rn_poa_new.restype = ctypes.c_void_p
    lib.rn_poa_free.argtypes = [ctypes.c_void_p]
    lib.rn_poa_n_nodes.restype = i64
    lib.rn_poa_n_nodes.argtypes = [ctypes.c_void_p]
    lib.rn_poa_add_alignment.restype = None
    lib.rn_poa_rank_arrays.restype = i64
    lib.rn_poa_msa.restype = i64
    lib.rn_poa_align.restype = i64
    lib.rn_score_pairs.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _arr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def build_sketch_native(seqs: List[str], k: int, both_strands: bool,
                        kmax: int):
    """Native twin of ops/sketch.build_sketch_tables; returns the same
    SketchTables or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from .ops.sketch import BV_WORDS, SketchTables

    n = len(seqs)
    blob = "".join(seqs).encode("ascii")
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    lens = np.diff(offsets).astype(np.int32)
    hbp = np.empty((n, kmax), np.uint32)
    hs = np.empty((n, kmax), np.uint32)
    ps = np.empty((n, kmax), np.int32)
    bvp = np.empty((n, BV_WORDS), np.uint32)
    bvc = np.empty(n, np.int32)
    if both_strands:
        rev_hs = np.empty((n, kmax), np.uint32)
        rev_ps = np.empty((n, kmax), np.int32)
        rev_bvp = np.empty((n, BV_WORDS), np.uint32)
    else:
        rev_hs = rev_ps = rev_bvp = None
        dummy_u32 = np.empty(1, np.uint32)
        dummy_i32 = np.empty(1, np.int32)

    lib.rn_build_sketch(
        blob, _arr(offsets, ctypes.c_int64), ctypes.c_int64(n),
        ctypes.c_int(k), ctypes.c_int(1 if both_strands else 0),
        ctypes.c_int64(kmax),
        _arr(hbp, ctypes.c_uint32), _arr(hs, ctypes.c_uint32),
        _arr(ps, ctypes.c_int32),
        _arr(rev_hs if both_strands else dummy_u32, ctypes.c_uint32),
        _arr(rev_ps if both_strands else dummy_i32, ctypes.c_int32),
        _arr(bvp, ctypes.c_uint32),
        _arr(rev_bvp if both_strands else dummy_u32, ctypes.c_uint32),
        _arr(bvc, ctypes.c_int32))
    return SketchTables(hbp=hbp, hs=hs, ps=ps, nk=(lens - k).astype(np.int32),
                        lens=lens, bvp=bvp, bvc=bvc, rev_hs=rev_hs,
                        rev_ps=rev_ps, rev_bvp=rev_bvp, kmer_size=k)


class NativePoaGraph:
    """Native twin of ops/poa.POAGraph + align_local (fallback aligner)."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.rn_poa_new()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.rn_poa_free(ctypes.c_void_p(self._h))
                self._h = None
        except Exception:  # interpreter teardown: ctypes may be gone
            pass

    def n_nodes(self) -> int:
        return int(self._lib.rn_poa_n_nodes(ctypes.c_void_p(self._h)))

    def add_alignment(self, aln, seq: str) -> None:
        n = len(aln)
        nodes = np.array([a for a, _ in aln], dtype=np.int32)
        pos = np.array([b for _, b in aln], dtype=np.int32)
        self._lib.rn_poa_add_alignment(
            ctypes.c_void_p(self._h), _arr(nodes, ctypes.c_int32),
            _arr(pos, ctypes.c_int32), ctypes.c_int64(n),
            seq.encode("ascii"), ctypes.c_int64(len(seq)))

    def rank_arrays(self, n_cap: int, pmax: int):
        """Returns (letters [n_cap] u8, preds [n_cap, pmax] i32, rank_nodes)
        or None on capacity overflow."""
        letters = np.zeros(n_cap, np.uint8)
        preds = np.empty((n_cap, pmax), np.int32)
        rank_nodes = np.empty(n_cap, np.int32)
        n = self._lib.rn_poa_rank_arrays(
            ctypes.c_void_p(self._h), ctypes.c_int64(n_cap),
            ctypes.c_int64(pmax), _arr(letters, ctypes.c_uint8),
            _arr(preds, ctypes.c_int32), _arr(rank_nodes, ctypes.c_int32))
        if n < 0:
            return None
        return letters, preds, rank_nodes[:n]

    def msa(self) -> List[str]:
        shape = np.zeros(2, np.int64)
        size = self._lib.rn_poa_msa(ctypes.c_void_p(self._h), None,
                                    _arr(shape, ctypes.c_int64))
        buf = ctypes.create_string_buffer(int(max(size, 1)))
        self._lib.rn_poa_msa(ctypes.c_void_p(self._h), buf,
                             _arr(shape, ctypes.c_int64))
        nrows, ncols = int(shape[0]), int(shape[1])
        raw = buf.raw[: nrows * ncols].decode("ascii")
        return [raw[i * ncols:(i + 1) * ncols] for i in range(nrows)]

    def align_local(self, seq: str, params) -> list:
        cap = self.n_nodes() + len(seq) + 8
        nodes = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int32)
        n = self._lib.rn_poa_align(
            ctypes.c_void_p(self._h), seq.encode("ascii"),
            ctypes.c_int64(len(seq)), ctypes.c_int(params.match),
            ctypes.c_int(params.mismatch), ctypes.c_int(params.gap_open),
            ctypes.c_int(params.gap_extend), _arr(nodes, ctypes.c_int32),
            _arr(pos, ctypes.c_int32), ctypes.c_int64(cap))
        if n < 0:
            raise RuntimeError("alignment buffer overflow")
        return [(int(nodes[i]), int(pos[i])) for i in range(n)]


def score_pairs_native(tables, a_ids, b_ids, b_rev, kmer_size: int,
                       hc_max_dist: int = 10):
    """Exact host scoring of pairs against SketchTables (C++ twin of the
    oracle's common_kmers + calc_similarity + var).  Returns dict of arrays:
    bases, hc, var (float64, NaN for the single-distance quirk), n_dist."""
    lib = _load()
    if lib is None:
        return None
    n = len(a_ids)
    a = np.ascontiguousarray(a_ids, dtype=np.int32)
    b = np.ascontiguousarray(b_ids, dtype=np.int32)
    r = np.ascontiguousarray(b_rev, dtype=np.uint8)
    bases = np.empty(n, np.int64)
    hc = np.empty(n, np.int64)
    var = np.empty(n, np.float64)
    ndist = np.empty(n, np.int64)
    dummy_u32 = np.zeros(1, np.uint32)
    dummy_i32 = np.zeros(1, np.int32)
    rev_hs = tables.rev_hs if tables.rev_hs is not None else dummy_u32
    rev_ps = tables.rev_ps if tables.rev_ps is not None else dummy_i32
    lib.rn_score_pairs(
        _arr(tables.hbp, ctypes.c_uint32), _arr(tables.hs, ctypes.c_uint32),
        _arr(tables.ps, ctypes.c_int32), _arr(rev_hs, ctypes.c_uint32),
        _arr(rev_ps, ctypes.c_int32), _arr(tables.nk, ctypes.c_int32),
        ctypes.c_int64(tables.kmax), _arr(a, ctypes.c_int32),
        _arr(b, ctypes.c_int32), _arr(r, ctypes.c_uint8), ctypes.c_int64(n),
        ctypes.c_int(kmer_size), ctypes.c_int(hc_max_dist),
        _arr(bases, ctypes.c_int64), _arr(hc, ctypes.c_int64),
        _arr(var, ctypes.c_double), _arr(ndist, ctypes.c_int64))
    return {"bases": bases, "hc": hc, "var": var, "n_dist": ndist}
