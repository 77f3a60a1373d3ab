"""Device-resident POA pack engine: the whole per-pack read loop runs on the
device, three kernel launches per read step and no host sync, and no graph
state crosses to the host until the final MSA download.

Port of rattle_tpu/correct/pack_engine.py, whose step is one jitted
program.  The graph lives on the device in node-id space and every step is:

    poa_align (the read against the graph in rank order)
      ->  poa_thread (the moves decoded and threaded into the graph:
          scatters, all conflict-free; the re-rank's keys)
      ->  poa_rerank (the incremental re-rank, in the order of one stable
          sort of the keys, and the next step's rank-space inputs)

The threading vectorizes because one read's path touches each group at
most once (ranks strictly increase along the path and groups are
rank-consecutive), so letter lookups, group joins, edge inserts and member
appends are independent scatters.  The incremental group order is the
"incr" order of ops/poa.py: every run of brand-new groups sorts immediately
before the next placed group on the path (key = next_placed_pos * SK +
run_index), runs with no later placed target go at the end.

Packs over capacity (reads longer than W - 2 = 4,094 bases, more than 256
reads, more than N nodes, more than PMAX = 16 predecessors, more than 8
group members) go to the host aligner for the whole pack, counted per cause
in ``stats`` (identical semantics by construction).

What differs from the JAX engine, none of it visible in a pack's MSA:
* the state is updated in place; every scatter target carries one spare
  slot at the end of its node (or path) axis that takes the masked writes
  (JAX drops out-of-range indices, torch raises on them);
* poa_align takes predecessor *rows*, which poa_rerank gathers through
  node_rank, instead of translating nodes through a rank table inside the
  kernel;
* shapes are exact (reads per group, path length, lanes), not bucketed:
  nothing is compiled per shape;
* the lane caps are this card's (see CONFIGS).

Reference behavior: correct.cpp:377-478 (spoa keeps graphs in-core).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve
from ..ops.kernels import POA_GA as GA
from ..ops.kernels import POA_PMAX as PMAX
from ..ops.kernels import POA_RANK_FIELDS as RANK_FIELDS
from ..ops.kernels import _take, poa_align, poa_rerank, poa_scratch_elems
from ..ops.kernels import poa_rank_space as rank_space
from ..ops.kernels import poa_thread

MAX_READS = 256            # reads per pack the device path takes
# (max read len + 2, graph node cap, lane cap) per column-width config.  The
# lane cap bounds the kernel's DP scratch, 6 bytes a cell (int16 H, F and
# direction rows of [n_cap + 1, w]): 25 MB, 101 MB and 403 MB a lane, so
# 6.4, 12.9 and 25.8 GB at the caps, beside at most 0.6 GB of graph state;
# the scratch is one buffer reused by every group.  A lane is a cluster of 4
# or 8 small CTAs (csrc/poa_align.cu), so lanes beyond what the card's 132 SMs
# hold at once queue up but cost nothing else.
CONFIGS = ((1024, 4096, 256), (2048, 8192, 128), (4096, 16384, 64))

# per-node arrays that take scatters: one spare slot on the node axis
_PADDED = ("letters", "npred", "preds", "grp_leader", "member_idx",
           "grp_size", "members", "grp_pos", "perm", "path")
_CAUSES = ((1, "node_cap"), (2, "pred_cap"), (4, "group_cap"))


def _cfg_for(lmax: int, n_reads: int):
    """(w, n_cap) of the narrowest config that holds the pack; None if the
    pack cannot run on the device (a read too long, or too many reads)."""
    if n_reads > MAX_READS:
        return None
    for w, n_cap, _lanes in CONFIGS:
        if lmax <= w - 2:
            return (w, n_cap)
    return None


def _width_for(lmax: int) -> int:
    """Narrowest column count (a power of two from 1024) for reads of at
    most ``lmax`` bases."""
    w = 1024
    while lmax > w - 2:
        w *= 2
    return w


def _init_state(seqs: torch.Tensor, lens: torch.Tensor,
                n_reads: torch.Tensor, n_cap: int, tot_cap: int) -> dict:
    """seqs [B, R, W] uint8, lens [B, R], n_reads [B] int32.  Arrays named
    in ``_PADDED`` are one slot longer than the JAX engine's."""
    b = seqs.shape[0]
    dev = seqs.device
    i32 = torch.int32
    n1 = n_cap + 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=i32, device=dev)

    offsets = torch.cumsum(lens, dim=1, dtype=i32) - lens
    return dict(
        seqs=seqs, lens=lens, n_reads=n_reads, offsets=offsets,
        letters=zeros(b, n1), npred=zeros(b, n1),
        preds=torch.full((b, n1, PMAX), -1, dtype=i32, device=dev),
        n_nodes=zeros(b),
        grp_leader=zeros(b, n1), member_idx=zeros(b, n1),
        grp_size=zeros(b, n1),
        members=torch.full((b, n1, GA), -1, dtype=i32, device=dev),
        grp_pos=zeros(b, n1), n_groups=zeros(b),
        node_rank=zeros(b, n_cap), perm=zeros(b, n1),
        path=zeros(b, tot_cap + 1),
        # 0 = ok; else cause bitmask: 1 node-cap, 2 pred-cap, 4 group-cap
        fallback=zeros(b),
    )


def pack_state_from_numpy(state: Dict[str, np.ndarray],
                          device="cuda") -> dict:
    """The JAX engine's state dictionary (the arrays of its ``_init_state``,
    as numpy) as this engine's: same values, the scatter targets padded by
    their spare slot, sequences as uint8."""
    dev = resolve(device)
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        if name == "seqs":
            t = torch.from_numpy(arr.astype(np.uint8))
        else:
            t = torch.from_numpy(arr.astype(np.int32))
        if name in _PADDED:
            pad = [(0, 0)] * t.dim()
            pad[1] = (0, 1)
            fill = -1 if name in ("preds", "members") else 0
            flat = [x for lo_hi in reversed(pad) for x in lo_hi]
            t = torch.nn.functional.pad(t, flat, value=fill)
        out[name] = t.contiguous().to(dev)
    return out


def _align(st: dict, t: int, w: int, match: int = 5, mismatch: int = -4,
           go: int = -8, ge: int = -6,
           scratch: Optional[torch.Tensor] = None):
    """poa_align of read ``t`` of every lane at width ``w``: its rank-space
    inputs live in ``st`` between steps (poa_rerank writes the next step's);
    a state without them (``pack_state_from_numpy``) gets them from
    ``rank_space`` first.  Returns (packed, tlen, best)."""
    if RANK_FIELDS[0] not in st:
        st.update(zip(RANK_FIELDS, rank_space(st)))
        st["keys"] = torch.empty_like(st["letters"])
    return poa_align(
        *(st[f] for f in RANK_FIELDS), st["n_nodes"], st["seqs"][:, t, :w],
        st["lens"][:, t], t, st["n_reads"], st["fallback"], match=match,
        mismatch=mismatch, go=go, ge=ge, scratch=scratch)


def _step(st: dict, t: int, w_eff: Optional[int] = None, match: int = 5,
          mismatch: int = -4, go: int = -8, ge: int = -6,
          scratch: Optional[torch.Tensor] = None) -> dict:
    """Align read ``t`` of every lane and thread it into its graph: three
    kernels, poa_align -> poa_thread -> poa_rerank, and no host sync.
    Updates ``st`` in place and returns it."""
    # effective column count for THIS step: the DP row cost is ~linear in
    # w, and pack reads arrive length-descending (the global length sort
    # orders cluster members), so later steps run at narrower widths
    w = st["seqs"].shape[2] if w_eff is None else w_eff
    aligned = _align(st, t, w, match, mismatch, go, ge, scratch)
    poa_thread(st, t, w, *aligned)
    poa_rerank(st)
    return st


def _finalize(st: dict):
    """MSA column of every path entry, and the lanes' final counters."""
    n = st["node_rank"].shape[1]
    path = st["path"][:, :-1]
    lead = _take(st["grp_leader"], path.clamp(0, n - 1))
    cols = _take(st["grp_pos"], lead.clamp(0, n - 1))
    return cols, st["n_groups"], st["n_nodes"], st["fallback"]


class PackEngine:
    """Groups packs into lane batches and runs them through the device."""

    def __init__(self, device="cuda", max_lanes: int = 256):
        self.device = resolve(device)
        self.max_lanes = max_lanes
        self._scratch: Optional[torch.Tensor] = None
        # fb_* split fallback_packs by cause: the device share is accounted
        # per cause
        self.stats = {"device_packs": 0, "fallback_packs": 0,
                      "device_bases": 0, "host_bases": 0, "steps": 0,
                      "fb_length": 0, "fb_reads": 0, "fb_node_cap": 0,
                      "fb_pred_cap": 0, "fb_group_cap": 0}

    def msa_many(self, all_seqs: List[List[str]], match: int = 5,
                 mismatch: int = -4, go: int = -8, ge: int = -6,
                 host_fn=None) -> List[Optional[list]]:
        """Returns per pack: list of gap-padded MSA rows, or None when the
        pack must be handled by the host fallback.

        With ``host_fn(seqs) -> rows``, fallback packs run on a worker
        pool OVERLAPPED with the device groups (the native aligner
        releases the GIL; the device thread mostly waits on the card), and
        every entry comes back filled."""
        results: List[Optional[list]] = [None] * len(all_seqs)
        pool = None
        futures = {}
        if host_fn is not None:
            pool = ThreadPoolExecutor(
                max_workers=min(32, os.cpu_count() or 1))

        def to_host(i, total, cause):
            self.stats["fallback_packs"] += 1
            self.stats["host_bases"] += total
            self.stats["fb_" + cause] += 1
            if pool is not None:
                futures[i] = pool.submit(host_fn, all_seqs[i])

        jobs = []
        for i, seqs in enumerate(all_seqs):
            if not seqs:
                results[i] = []
                continue
            lmax = max(len(s) for s in seqs)
            total = sum(len(s) for s in seqs)
            cfg = _cfg_for(lmax, len(seqs))
            if cfg is None:
                to_host(i, total,
                        "reads" if len(seqs) > MAX_READS else "length")
                continue
            # group by READ COUNT within a config: the lockstep group runs
            # max(n_reads) steps, so mixing a 30-read pack into a 200-read
            # group leaves its lane idle for 170 steps
            jobs.append((cfg, len(seqs), i))

        jobs.sort()
        groups = []
        cur = []
        for job in jobs:
            if cur and (job[0] != cur[0][0]
                        or len(cur) >= self._lanes(job[0])):
                groups.append(cur)
                cur = []
            cur.append(job)
        if cur:
            groups.append(cur)

        try:
            for group in groups:
                self._run_group(group, all_seqs, results,
                                (match, mismatch, go, ge), to_host)
            if pool is not None:
                t0 = time.perf_counter()
                for i, fut in futures.items():
                    results[i] = fut.result()
                self.stats["host_wait_s"] = round(
                    self.stats.get("host_wait_s", 0.0)
                    + time.perf_counter() - t0, 2)
        finally:
            if pool is not None:
                pool.shutdown()
        return results

    def _lanes(self, cfg) -> int:
        for w, _n, lanes in CONFIGS:
            if w == cfg[0]:
                return min(self.max_lanes, lanes)
        raise ValueError(f"unknown config {cfg}")

    def _scratch_for(self, b: int, n_cap: int, w: int):
        """The DP scratch, one buffer grown to the largest group so far
        (None on the CPU, where the plain version keeps its own rows)."""
        if self.device.type != "cuda":
            return None
        need = poa_scratch_elems(b, n_cap, w)
        if self._scratch is None or self._scratch.numel() < need:
            self._scratch = None          # free before growing
            self._scratch = torch.empty(need, dtype=torch.int16,
                                        device=self.device)
        return self._scratch

    def _run_group(self, group, all_seqs, results, params, to_host=None):
        def mark(key, t0):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats[key] = round(self.stats.get(key, 0.0)
                                    + time.perf_counter() - t0, 2)
            return time.perf_counter()

        w, n_cap = group[0][0]
        ids = [i for _, _, i in group]
        b = len(ids)
        r_max = max(len(all_seqs[i]) for i in ids)
        tmark = time.perf_counter()
        seqs_arr = np.zeros((b, r_max, w), np.uint8)
        lens = np.zeros((b, r_max), np.int32)
        n_reads = np.zeros((b,), np.int32)
        for li, i in enumerate(ids):
            for t, s in enumerate(all_seqs[i]):
                raw = np.frombuffer(s.encode("ascii"), np.uint8)
                seqs_arr[li, t, :len(raw)] = raw
                lens[li, t] = len(raw)
            n_reads[li] = len(all_seqs[i])
        tot_cap = int(lens.sum(axis=1).max())

        tmark = mark("t_fill_s", tmark)
        dev = self.device
        st = _init_state(torch.from_numpy(seqs_arr).to(dev),
                         torch.from_numpy(lens).to(dev),
                         torch.from_numpy(n_reads).to(dev),
                         n_cap=n_cap, tot_cap=tot_cap)
        scratch = self._scratch_for(b, n_cap, w)
        match, mismatch, go, ge = params
        # per-step effective width: the max over lanes of lens[:, t] is
        # non-increasing in t (each lane's reads are length-descending), so
        # w_t only shrinks; it is a runtime argument of the kernel
        for t in range(r_max):
            wt = min(_width_for(int(lens[:, t].max())), w)
            _step(st, t, w_eff=wt, match=match, mismatch=mismatch, go=go,
                  ge=ge, scratch=scratch)
        self.stats["steps"] += r_max
        tmark = mark("t_steps_s", tmark)
        cols_d, n_groups_d, n_nodes_d, fb_d = _finalize(st)
        cols = cols_d.cpu().numpy()
        n_groups = n_groups_d.cpu().numpy()
        fb = fb_d.cpu().numpy()
        del st
        tmark = mark("t_fetch_s", tmark)

        for li, i in enumerate(ids):
            total = int(lens[li].sum())
            if fb[li]:
                cause = next(c for bit, c in _CAUSES if fb[li] & bit)
                if to_host is not None:
                    to_host(i, total, cause)
                else:
                    self.stats["fallback_packs"] += 1
                    self.stats["host_bases"] += total
                    self.stats["fb_" + cause] += 1
                continue
            self.stats["device_packs"] += 1
            self.stats["device_bases"] += total
            ncols = int(n_groups[li])
            rows = []
            off = 0
            for t in range(int(n_reads[li])):
                ln = int(lens[li, t])
                row = np.full(ncols, ord("-"), np.uint8)
                row[cols[li, off:off + ln]] = seqs_arr[li, t, :ln]
                rows.append(row.tobytes().decode("ascii"))
                off += ln
            results[i] = rows
        mark("t_decode_s", tmark)
