"""Split csrc/poa_rerank.cu's time between its order and its loads, and
its order by counting against its sort, on the card.

    python -m rattle_tpu_torch.pipeline.probe_rerank

Grows chip_smoke.py's timed groups (profile_correct.grown_group: the main
path's lane count at each width, 12 read steps) and one of short packs
(``GROUPS``), and threads step 12 into each with poa_thread.  Then it
builds copies of the re-rank source changed by text substitution
(``CUTS``: every lane sorted, as the kernel does for keys without the
structure; or every thread ended by an ``exit`` after one more of its
phases: the keys' loads, the structure check, the histogram, the
positions, the starts (the order; also with the sort), the node ranks,
perm) and times the package kernel and each copy on those states as
device time a launch (profile_correct.queued_ms: launches queued
back to back; the re-rank reads nothing it writes before writing it, so it
repeats on one state).  A cut's outputs are incomplete and are not
checked.  The lines it substitutes are found by exact text: if the source
no longer holds one, it fails and names it.

Prints the kernel's SASS instruction count (``cuobjdump -sass``), one line
a group and build, then one JSON object with every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.correct import pack_engine as pe
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline.profile_correct import (REF_LENS, grown_group,
                                                       queued_ms)

_EXIT = "  asm volatile(\"exit;\");\n"
_COUNTED = "  const bool counted =\n"
_CHECK = "  int n_c = 0, n_a = 0, last_c = -1, first_c = kNone, max_x = -1;\n"
_HIST = "  smem_scan<true>(hist, n_a, red);"
_POSITIONS = "    total = smem_scan<false>(starts, g, red);\n"
_ORDERED = "  // ---- node ranks ----\n"
_RANKED = "  for (int v = tid; v < nn; v += kThreads) {\n"
_PERMUTED = "  // ---- the next step's rank-space inputs"
_SORT = (_COUNTED, "  const bool counted = false &&\n")


def _exit_before(anchor: str, keep: str = "") -> tuple:
    """An edit that ends every thread just before ``anchor``, after
    ``keep`` (statements that keep the work before it live)."""
    return (anchor, keep + _EXIT + anchor)


# label: the substitutions of that copy of the source, each copy ending
# every thread at a later point of the kernel (the order by counting unless
# it says sort)
CUTS = {
    "every lane sorted": (_SORT,),
    "exit after the keys' loads": (_exit_before(
        _CHECK, "  if (nn > 0 && key_s[tid * 7 % nn] + sz_s[tid * 13 % nn] == 7)"
        "\n    nr_l[0] = bad;\n"),),
    "exit after the check": (_exit_before(
        "  // ---- grp_pos, each id's position",
        "  if (tid == 0) nr_l[0] = counted + c_before;\n"),),
    "exit after the histogram": (_exit_before(_HIST),),
    "exit after the positions": (_exit_before(_POSITIONS),),
    "exit after the order": (_exit_before(
        _ORDERED, "  if (tid == 0) nr_l[0] = total;\n"),),
    "exit after the order (sort)": (_SORT, _exit_before(
        _ORDERED, "  if (tid == 0) nr_l[0] = total;\n")),
    "exit after the node ranks": (_exit_before(_RANKED),),
    "exit after perm": (_exit_before(_PERMUTED),),
}
# the timed groups: chip_smoke.py's at each width, and at W = 1024 one of
# short packs (a ~400-base transcript) at the lane count of the largest
# W = 1024 group of the main path's correct run
GROUPS = [(w, n_cap, lanes, ref_len) for (w, n_cap, lanes), ref_len
          in zip(pe.CONFIGS, REF_LENS)] + [(1024, 4096, 105, 400)]
BUILD = os.path.join(os.path.dirname(_ext.BUILD_DIR), "probe_rerank")


def _source(edits) -> str:
    src, _so = _ext.library_path("poa_rerank")
    with open(src) as fh:
        text = fh.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"the re-rank source changed: {old!r} is "
                               "gone; update probe_rerank")
        text = text.replace(old, new)
    return text


def _build_all(sources) -> dict:
    """{label: launch function} of every changed source, one nvcc each, all
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
    fns = {}
    fn_name, argtypes = _ext._SIGNATURES["poa_rerank"]
    for label, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe_rerank {label}: nvcc failed\n{out}")
        fn = getattr(ctypes.CDLL(so), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def sass_instructions(so: str) -> int:
    """Instructions of a built library's SASS (``cuobjdump -sass``, beside
    nvcc), the code a launch may have to fetch."""
    tool = os.path.join(os.path.dirname(_ext.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    return sum(1 for line in out.splitlines()
               if line.lstrip().startswith("/*") and ";" in line)


def _launcher(fn, counter):
    """A re-rank of a state through launch function ``fn``, its sorted
    lanes counted in ``counter``."""
    def run(st):
        b, n = st["node_rank"].shape
        ptr = [st[f].data_ptr() for f in (
            "keys", "grp_size", "grp_leader", "member_idx", "preds", "npred",
            "letters", "n_nodes", "n_groups", "grp_pos", "perm", "node_rank",
            *kernels.POA_RANK_FIELDS)]
        rc = fn(*ptr, counter.data_ptr(), b, n,
                kernels._stream(st["keys"].device))
        if rc:
            raise RuntimeError(f"poa_rerank copy: cudaError {rc}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_rerank needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    fns = _build_all({label: _source(edits) for label, edits in CUTS.items()})
    _src, so = _ext.library_path("poa_rerank")
    _ext.load("poa_rerank")  # built at first use
    sass = sass_instructions(so)
    print(f"poa_rerank: {sass} SASS instructions")
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    res = []
    for w, n_cap, lanes, ref_len in GROUPS:
        st, t, aligned = grown_group(dev, w, n_cap, lanes, ref_len)
        kernels.poa_thread(st, t, w, *aligned)
        nn = st["n_nodes"]
        runs = {"kernel": kernels.poa_rerank}
        runs.update((label, _launcher(fn, counter))
                    for label, fn in fns.items())
        for label, run in runs.items():
            ms = queued_ms(run, [st] * 21)
            res.append(dict(build=label, width=w, lanes=lanes,
                            nodes=int(nn.sum()), max_nodes=int(nn.max()),
                            device_ms=ms))
            print(f"W={w} lanes={lanes} nodes={int(nn.sum())} (largest "
                  f"lane {int(nn.max())}): {label}: {ms:.4f} ms a launch")
        del st, aligned
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sass_instructions": sass, "launches": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
