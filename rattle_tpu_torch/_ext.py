"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface under ``build/rattle_tpu_torch/`` at the repository
root, named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads as it is.  The libraries are loaded with
``ctypes``; each entry point takes device pointers and a stream and returns
``cudaGetLastError()``.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rattle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("bv_common", "lis_filter", "poa_align", "join_expand",
           "score_decide", "greedy_owner", "poa_thread", "poa_rerank",
           "poa_align_batch", "gate_block", "absorb_rest")
# csrc/mma_rate.cu, a probe of the tensor cores' rate that chip_smoke.py
# builds beside the kernels (no path launches it)
PROBES = ("mma_rate",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of each library's launch functions (pointers and the stream as
# c_void_p, so ctypes never cuts a 64-bit pointer to an int): one (name,
# argtypes) pair, or a tuple of them for a library of several kernels
_SIGNATURES = {
    "bv_common": ("bv_common_launch", [_P, _P, _P, _I, _I, _P]),
    "lis_filter": ("lis_filter_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "poa_align": ("poa_align_launch",
                  [_P] * 8 + [_I, _L, _I] + [_I] * 7 + [_P] * 8),
    "join_expand": ("join_expand_launch",
                    [_P] * 8 + [_I] * 3 + [_P] * 2 + [_I] * 3 + [_P]
                    + [_I] * 2 + [_P] * 6),
    "score_decide": ("score_decide_launch",
                     [_P] * 11 + [_I, _P, _L, _P, _L, _I, _I, _P, _P]),
    "greedy_owner": ("greedy_owner_launch", [_P, _I, _I, _P, _P]),
    "poa_thread": ("poa_thread_launch", [_P] * 21 + [_I] * 7 + [_P]),
    "poa_rerank": ("poa_rerank_launch", [_P] * 16 + [_I] * 2 + [_P]),
    "poa_align_batch": ("poa_align_batch_launch",
                        [_P, _P, _I, _I, _P, _P, _P] + [_I] * 8 + [_P] * 5),
    "gate_block": (("gate_tile_launch",
                    [_P, _P, _I, _I] + [_P] * 10 + [_P, _L, _P, _I, _P, _I]
                    + [_P] * 3 + [_I, _P]),
                   ("gate_emit_launch", [_P, _I, _I] + [_P] * 4
                    + [_I] + [_P] * 3)),
    "absorb_rest": ("absorb_rest_launch", [_P] + [_I] * 5 + [_P] * 2),
    "mma_rate": ("mma_rate_launch", [_I, _I, _I, _P, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels are "
                       "built on the machine with the card")


_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def library_path(name: str) -> Tuple[str, str]:
    """(source, library) paths of kernel ``name``.  The library's name
    hashes the source, the headers of csrc/ it includes and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        text = fh.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    for header in _INCLUDE.findall(text):
        with open(os.path.join(CSRC, header.decode()), "rb") as fh:
            digest.update(fh.read())
    so = f"lib{name}_{digest.hexdigest()[:16]}.so"
    return src, os.path.join(BUILD_DIR, so)


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: (seconds, ptxas
    report)} for the kernels it compiled; raises if any compile fails."""
    nvcc = None
    jobs = []
    for name in names:
        src, so = library_path(name)
        if os.path.exists(so):
            continue
        nvcc = nvcc or nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    report = {}
    failures = []
    for name, so, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        report[name] = (time.perf_counter() - t0, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        _src, so = library_path(name)
        if not os.path.exists(so):
            build([name])
        lib = ctypes.CDLL(so)
        sigs = _SIGNATURES[name]
        for fn_name, argtypes in (sigs,) if isinstance(sigs[0], str) \
                else sigs:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
