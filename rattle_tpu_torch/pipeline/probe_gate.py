"""Split csrc/gate_block.cu's pass 1 between its parts on the card.

    python -m rattle_tpu_torch.pipeline.probe_gate [--absorb-only]

Builds copies of the gate source with one part of pass 1 cut out by text
substitution (``CUTS``: the epilogue, the stage loads, the wgmma product;
and two variants: a ring of three stages, no tile skip), and times pass 1
of the package's build and of each copy as device time a launch
(``profile_gate.queued_ms``, gate_sides_kernel included)
on profile_gate's gates: the main path's first block (with its score
cache, and with the cache off), the 1,024 x every-read sweep and the
4,096 x 65,536 sweep tile; then pass 2 of the package's build alone.  The
differences split pass 1 between the epilogue, the loads and the product.
A cut's outputs are wrong and are not checked.  First it times absorb_rest
on the first sweep tile's win matrix under other launch plans
(``ABSORB_PLANS``, each checked exact) beside the package's;
``--absorb-only`` stops there.  The lines it substitutes are found by
exact text: if the source no longer holds one, it fails and names it.

Prints one line a gate and build, then one JSON object with every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from rattle_tpu_torch import _ext
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.pipeline import profile_gate as pg

_EPILOGUE = "    epilogue(g, s, p0, s0, d);\n"
_LOADS = "    if (t < n_tiles && i < kStages)\n      bv_tile::load_stage("
_WGMMA = ("        wgmma_b1(d, sw128_desc(a + ks * 8), "
          "sw128_desc(b + ks * 8));\n")
_BUFS = "constexpr int kBufs = 2;"
_SKIPS = "    return s.row_min[t % g.tiles_r] < s.col_max[t / g.tiles_r];"
# (label, [(line of the source, what replaces it)]): cuts of a part, then
# two variants of the design (the ring one stage deeper; no tile skip)
CUTS = {
    "no epilogue": [(_EPILOGUE, "    if (d[0] == 0xffffffffu) g.mask[0] = "
                                "d[1] + d[63];\n")],
    "no loads": [(_LOADS, "    if (false)\n      bv_tile::load_stage(")],
    "no wgmma": [(_WGMMA, "        d[ks] += a[threadIdx.x + ks] ^ "
                          "b[threadIdx.x];\n")],
    "ring of 3 stages": [(_BUFS, "constexpr int kBufs = 3;")],
    "no tile skip": [(_SKIPS, "    return true;")],
}
BUILD = os.path.join(os.path.dirname(_ext.BUILD_DIR), "probe_gate")


def _source(edits) -> str:
    src, _so = _ext.library_path("gate_block")
    with open(src) as fh:
        text = fh.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"the gate source changed: {old!r} is gone; "
                               "update probe_gate")
        text = text.replace(old, new)
    return text


def _build_all(sources) -> dict:
    """{label: loaded library} of every cut source, one nvcc each, all
    started together (the sources include csrc/bv_tile.cuh from csrc/)."""
    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for label, text in sources.items():
        name = "".join(c if c.isalnum() else "_" for c in label)
        var_src = os.path.join(BUILD, f"{name}.cu")
        with open(var_src, "w") as fh:
            fh.write(text)
        so = os.path.join(BUILD, f"lib{name}.so")
        jobs[label] = (so, subprocess.Popen(
            [_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-I", _ext.CSRC, "-o", so,
             var_src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe_gate {label}: nvcc failed\n{out}")
        lib = ctypes.CDLL(so)
        for fn_name, argtypes in _ext._SIGNATURES["gate_block"]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs


# absorb_rest plans tried beside the package's on the first sweep tile's
# win matrix: (layout, strips) (csrc/absorb_rest.cu: 0 the 16-byte panels,
# 1 a lane a column)
ABSORB_PLANS = ((1, 1), (0, 1), (0, 2), (0, 3), (0, 9))


def absorb_plans(dev, w) -> dict:
    """Device time a launch of absorb_rest on ``w`` under each of
    ABSORB_PLANS (rows split evenly), each checked against the plain
    version, and under the package's own plan."""
    s_, c = w.shape
    fn = _ext.load("absorb_rest").absorb_rest_launch
    ref = kernels.absorb_rest_plain(w)
    plan = kernels.absorb_rest_plan(s_, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    res = {"package": pg.queued_ms(lambda: kernels.absorb_rest(w), 50)}
    for layout, strips in ABSORB_PLANS:
        rows = -(-s_ // strips)
        out = torch.empty(c, dtype=torch.int32, device=dev)
        label = f"{('panels', 'columns')[layout]}, {strips} strips"

        def once():
            kernels._raise_on(fn(w.data_ptr(), s_, c, strips, rows, layout,
                                 out.data_ptr(), kernels._stream(dev)),
                              "absorb_rest")
        once()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise RuntimeError(f"absorb_rest plan {label} differs")
        res[label] = pg.queued_ms(once, 50)
    return res


def _pass1(lib, args) -> None:
    """Pass 1 of ``lib``'s build on the gate ``args``, launched as
    kernels.gate_block_pass1 launches the package's (its plan, fresh
    outputs); the outputs are dropped."""
    (bvp_rows, bvc_rows, order_rows, group_rows, bvp_cols, bvc_cols,
     order_cols, group_cols, tab, cache, cache_n, row_ids, col_ids, w,
     strand_val, nk, bounds) = args
    dev = w.device
    a, c = bvp_rows.shape[0], bvp_cols.shape[0]
    n_cls = bounds.shape[0] + 1
    plan = kernels.gate_block_plan(a, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    n_words = -(-c // 32)
    mask = torch.empty((a, n_words), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * n_cls * a + 1 + 2 * n_words + plan["tiles_r"]
                          + plan["tiles_c"], dtype=torch.int32, device=dev)
    class_counts = torch.empty(n_cls, dtype=torch.int32, device=dev)
    kernels._raise_on(lib.gate_tile_launch(
        bvp_rows.data_ptr(), bvp_cols.data_ptr(), a, c, bvc_rows.data_ptr(),
        bvc_cols.data_ptr(), order_rows.data_ptr(), order_cols.data_ptr(),
        group_rows.data_ptr(), group_cols.data_ptr(), row_ids.data_ptr(),
        col_ids.data_ptr(), nk.data_ptr(), tab.data_ptr(),
        None if cache is None else cache.data_ptr(), cache_n, w.data_ptr(),
        strand_val, bounds.data_ptr(), n_cls - 1, mask.data_ptr(),
        scratch.data_ptr(), class_counts.data_ptr(), plan["ctas"],
        kernels._stream(dev)), "probe_gate")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = {"kernel": _ext.load("gate_block")}
    libs.update(_build_all({label: _source(edits)
                            for label, edits in CUTS.items()}))
    eng = pg.main_engine(dev)
    (block, _sweep), (sweep_w,) = pg.capture_waves(eng)
    plans = absorb_plans(dev, sweep_w)
    print("absorb_rest on the first sweep tile's w " f"{list(sweep_w.shape)}"
          ": " + ", ".join(f"{k} {v:.4f} ms" for k, v in plans.items()),
          flush=True)
    if "--absorb-only" in sys.argv[1:]:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "absorb_ms": plans}))
        return 0
    off = list(block)
    off[9] = None
    gates = [("first wave's block", block),
             ("first wave's block, cache off", off),
             ("sweep 1024 x every read", pg.gate_args(
                 eng, pg.wide_rows(eng.n), np.arange(eng.n), False, seed=4)),
             ("sweep tile 4096 x 65536", pg.big_tile_args(eng))]
    res = []
    for what, args in gates:
        run = list(args)
        run[13] = args[13].clone()
        times = {label: pg.queued_ms(lambda lib=lib: _pass1(lib, run))
                 for label, lib in libs.items()}
        st = kernels.gate_block_pass1(*run)
        n_class = kernels.gate_block_read(st)
        times["pass 2"] = pg.queued_ms(
            lambda: kernels.gate_block_pass2(st, n_class))
        del st
        res.append(dict(what=what, shape=[args[0].shape[0],
                                          args[4].shape[0]], **times))
        print(f"{what}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in times.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "pass1_ms": res, "absorb_ms": plans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
