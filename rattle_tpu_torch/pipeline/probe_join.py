"""Split csrc/join_expand.cu's time on the main path's launches between the
phases of a pair's work, on the card.

    python -m rattle_tpu_torch.pipeline.probe_join

Runs ``cluster --rna`` on chip_smoke.py's main-path reads (utils/synth.py)
through the engine once, keeping the largest join launch of each (class
width, M tier).  Then it builds copies of the join source cut after one
phase of a staged pair's work (``CUTS``: staging both rows' hashes; then
the count walk and the group scan; then the emit walk) by text
substitution, and times the package kernel and each cut on every kept
launch (lone calls, CUDA-event medians).  The differences of their times
split a launch between staging, count walk, emit walk, and sort plus
stores.  A cut's outputs are incomplete and are not checked.  The lines it
substitutes are found by exact text: if the source no longer holds one,
it fails and names it.

Prints one line a launch and build, then one JSON object with every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.utils.synth import (MAIN_FAMILIES, MAIN_READS,
                                          MAIN_SEED, synthetic_reads)

# (line of the source, what replaces it): each ends a staged pair's work
# after a phase, with a store that keeps that phase's work live
_STAGED = "    join_pair<G>(SmemRow{sha, gpa}"
_COUNTED = "  const int n = static_cast<int>(total < m_cap ? total : m_cap);\n"
_EMITTED = "  if (n <= kWarpSortN) {"
CUTS = {
    "staging": (_STAGED, "    if (t == 0) out_total[pair] = sha[0] + shb[0];"
                         "\n    return;\n" + _STAGED),
    "staging, count walk": (_COUNTED, _COUNTED + "  if (t == 0) total_out[0]"
                            " = static_cast<int32_t>(total);\n  return;\n"),
    "staging, count walk, emit walk": (
        _EMITTED, "  group_sync<G>(grp);\n  if (t == 0) total_out[0] = "
        "static_cast<int32_t>(total + keys[0]);\n  return;\n" + _EMITTED),
}
BUILD = os.path.join(os.path.dirname(_ext.BUILD_DIR), "probe_join")


def _time_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _capture():
    """{(W, M): join_expand arguments} of the largest launches of a whole
    ``cluster --rna`` run of the engine."""
    reads = synthetic_reads(MAIN_READS, MAIN_FAMILIES, MAIN_SEED)
    seqs = sorted((s for _n, s, _f in reads), key=len, reverse=True)
    eng = bulk.BulkClusterEngine(seqs, ClusterParams(is_rna=True),
                                 device="cuda")
    kept = {}

    def join(*args, total=None, bound=None):
        key = (args[6].shape[1], args[11])
        if args[0].shape[0] > kept.get(key, [torch.empty(0)])[0].shape[0]:
            kept[key] = [a.clone() if i < 2 else a
                         for i, a in enumerate(args)]
        return kernels.join_expand(*args, total=total, bound=bound)

    saved, bulk.join_expand = bulk.join_expand, join
    try:
        eng.cluster()
    finally:
        bulk.join_expand = saved
    return kept


def _source(edit) -> str:
    src, _so = _ext.library_path("join_expand")
    with open(src) as fh:
        text = fh.read()
    old, new = edit
    if old not in text:
        raise RuntimeError(f"the join source changed: {old!r} is gone; "
                           "update probe_join")
    return text.replace(old, new)


def _build_all(sources) -> dict:
    """{label: loaded library} of every cut source, one nvcc each, all
    started together."""
    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for label, text in sources.items():
        name = "".join(c if c.isalnum() else "_" for c in label)
        var_src = os.path.join(BUILD, f"{name}.cu")
        with open(var_src, "w") as fh:
            fh.write(text)
        so = os.path.join(BUILD, f"lib{name}.so")
        jobs[label] = (so, subprocess.Popen(
            [_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so, var_src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    fn_name, argtypes = _ext._SIGNATURES["join_expand"]
    for label, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe_join {label}: nvcc failed\n{out}")
        lib = ctypes.CDLL(so)
        getattr(lib, fn_name).argtypes = argtypes
        libs[label] = lib
    return libs


def _launch(lib, args, m_cap):
    b = args[0].shape[0]
    dev = args[0].device
    p1 = torch.empty((b, m_cap), dtype=torch.int32, device=dev)
    p2 = torch.empty_like(p1)
    valid = torch.empty((b, m_cap), dtype=torch.bool, device=dev)
    total = torch.empty((b,), dtype=torch.int32, device=dev)
    bound = torch.zeros((1,), dtype=torch.int32, device=dev)
    rows, cols, row_ids, col_ids, row_tab, col_tab, hs_a, ps_a, hs_b, ps_b, \
        nk = args[:11]
    st = kernels._row_stride
    rc = lib.join_expand_launch(
        rows.data_ptr(), cols.data_ptr(), row_ids.data_ptr(),
        col_ids.data_ptr(), row_tab.data_ptr(), col_tab.data_ptr(),
        hs_a.data_ptr(), ps_a.data_ptr(), st(hs_a), st(ps_a), hs_a.shape[1],
        hs_b.data_ptr(), ps_b.data_ptr(), st(hs_b), st(ps_b), hs_b.shape[1],
        nk.data_ptr(), b, m_cap, p1.data_ptr(), p2.data_ptr(),
        valid.data_ptr(), total.data_ptr(), bound.data_ptr(),
        kernels._stream(dev))
    if rc:
        raise RuntimeError(f"join_expand cut: cudaError {rc}")
    return p1, p2, total, valid, bound


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_join needs a CUDA card", file=sys.stderr)
        return 2
    kept = _capture()
    libs = _build_all({f"cut after {label}": _source(edit)
                       for label, edit in CUTS.items()})
    res = []
    for (wa, m_cap), args in sorted(kept.items()):
        runs = {"kernel": lambda: kernels.join_expand(*args[:11], m_cap)}
        for label, lib in libs.items():
            runs[label] = lambda lib=lib: _launch(lib, args, m_cap)
        for label, fn in runs.items():
            ms = _time_ms(fn)
            res.append(dict(build=label, width=wa, m_cap=m_cap,
                            pairs=args[0].shape[0], ms=ms))
            print(f"W={wa} M={m_cap} B={args[0].shape[0]}: {label}: "
                  f"{ms:.4f} ms")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "launches": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
