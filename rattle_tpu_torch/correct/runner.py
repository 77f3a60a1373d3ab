"""Pack runner of the correct stage: many packs' MSAs on one device.

Port of rattle_tpu/correct/tpu_runner.py.  ``batched_msa`` reads
RATTLE_POA_BACKEND on every call, as the JAX package does:

* unset (or anything else): the device pack engine (correct/pack_engine.py;
  the whole per-pack read loop on the device, one read step a launch
  sequence), with the host aligner for packs over its capacity;
* ``lockstep``: the round-3 runner kept for comparison (``LockstepRunner``):
  lane b holds pack b's graph on the host, every read step uploads each
  lane's rank-space graph, one ``poa_align_batch`` launch aligns all lanes,
  and the host threads the alignments and re-ranks;
* ``native``: every pack on the host aligner (the native C++ graph when the
  library builds, the Python one otherwise).

A runner is bound to one device: ``make_pack_runner(device)`` returns a
``PackRunner``, the ``pack_runner`` hook of ``driver.correct_reads`` with its
``batch_msa`` method.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CorrectParams
from ..device import resolve
from ..io.fastx import Read, sort_read_set
from ..ops import kernels, poa
from ..ops.poa_device import (SMALL_L, BatchedAlignment, alignment_to_host,
                              poa_align_batch)
from .consensus import (correct_read_pack, fix_msa_ends,
                        generate_consensus_vector)
from .pack_engine import PackEngine

BACKEND_ENV = "RATTLE_POA_BACKEND"
PMAX = 8          # predecessor cap per node; overflow -> host fallback
LANES = 8         # minimum packs in flight per device call
MAX_LANES = 128
# device-memory budget for the H/E/F DP cells (bytes) of a lockstep group;
# lanes per group are sized to fill it (the JAX package's figure, kept so
# that groups, and so LAST_STATS, are the same)
HBM_BUDGET = int(1.0 * 2**30)
RANK_CAP = 32767  # packed traceback stores rank+1 in 16 bits


def _round_pow2(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def _lanes_for(n_cap: int, l_cap: int) -> int:
    """Memory-budgeted lane count (a power of two)."""
    cell = 2 if l_cap <= SMALL_L else 4
    per_lane = 3 * (n_cap + 1) * (l_cap + 1) * cell \
        + n_cap * PMAX * 4 + (n_cap + l_cap) * 4
    lanes = max(1, HBM_BUDGET // max(per_lane, 1))
    p = 1
    while p * 2 <= lanes:
        p *= 2
    return max(LANES, min(MAX_LANES, p))


class _LaneState:
    """One pack's graph on the host; the native C++ graph when the library
    is available, the Python one otherwise.  The lockstep runner also keeps
    the lane's capacities and its rank-space arrays."""

    def __init__(self, seqs: List[str], n_cap: int = 1 << 30,
                 l_cap: int = 1 << 30):
        from .. import native
        self.native = native.available()
        self.graph = native.NativePoaGraph() if self.native else poa.POAGraph()
        self.seqs = seqs
        self.next_read = 0
        self.n_cap = n_cap
        self.l_cap = l_cap
        self.fallback = False
        self.rank_nodes: List[int] = []
        # sized at the first refresh_rank: the host aligner never needs them
        self.pred_arr: Optional[np.ndarray] = None
        self.letter_arr: Optional[np.ndarray] = None

    def n_nodes(self) -> int:
        return self.graph.n_nodes()

    def add_alignment(self, aln, seq: str) -> None:
        if self.native:
            self.graph.add_alignment(aln, seq)
        else:
            poa.add_alignment(self.graph, aln, seq)
        self.next_read += 1

    def align_fallback(self, seq: str, params: poa.POAParams):
        if self.native:
            if self.graph.n_nodes() == 0:
                return []
            return self.graph.align_local(seq, params)
        return poa.align_local(self.graph, seq, params)

    def msa(self) -> List[str]:
        return self.graph.msa()

    def refresh_rank(self) -> bool:
        """Rebuild the rank-space arrays; False if a capacity is exceeded
        (more than n_cap nodes, or a node with more than PMAX
        predecessors)."""
        g = self.graph
        if g.n_nodes() > self.n_cap:
            return False
        if self.native:
            out = g.rank_arrays(self.n_cap, PMAX)
            if out is None:
                return False
            self.letter_arr, self.pred_arr, self.rank_nodes = out
            return True
        if self.pred_arr is None:
            self.pred_arr = np.full((self.n_cap, PMAX), -1, dtype=np.int32)
            self.letter_arr = np.zeros(self.n_cap, dtype=np.uint8)
        _, order = g.topo_groups()
        self.rank_nodes = [nid for members in order for nid in members]
        rank_of = {nid: r for r, nid in enumerate(self.rank_nodes)}
        self.pred_arr.fill(-1)
        self.letter_arr.fill(0)
        for r, nid in enumerate(self.rank_nodes):
            self.letter_arr[r] = ord(g.letters[nid])
            ins = g.in_edges[nid]
            if not ins:
                self.pred_arr[r, 0] = 0
            else:
                if len(ins) > PMAX:
                    return False
                for k, a in enumerate(ins):
                    self.pred_arr[r, k] = rank_of[a] + 1
        return True


# the statistics after the last batched_msa call, as the JAX package keeps
# them: the pack engine's (packs and bases counted where they actually ran,
# fb_* the fallbacks by cause, read steps and the engine's section times)
# replace them; the lockstep runner adds its packs, bases and read steps
LAST_STATS = {"device_packs": 0, "fallback_packs": 0,
              "device_bases": 0, "host_bases": 0, "steps": 0,
              "fb_length": 0, "fb_reads": 0, "fb_node_cap": 0,
              "fb_pred_cap": 0, "fb_group_cap": 0}


def _host_msa(seqs: List[str], params: poa.POAParams) -> List[str]:
    st = _LaneState(seqs)
    for s in seqs:
        st.add_alignment(st.align_fallback(s, params), s)
    return st.msa()


class LockstepRunner:
    """The lockstep runner (rattle_tpu/correct/tpu_runner.py:174-268) on
    one device.

    ``stats``: device_packs / fallback_packs / device_bases / host_bases /
    steps of its runs (steps: read steps, one ``poa_align_batch`` launch
    each), ``t_align_s`` (upload, launch and fetch of the steps),
    ``t_fallback_s`` (the host aligner finishing the lanes that overflowed)
    and ``t_host_s`` (the rest: rank arrays, staging, threading, MSAs)."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self._scratch: Optional[torch.Tensor] = None
        self.stats = {"device_packs": 0, "fallback_packs": 0,
                      "device_bases": 0, "host_bases": 0, "steps": 0,
                      "t_align_s": 0.0, "t_fallback_s": 0.0,
                      "t_host_s": 0.0}

    def _scratch_for(self, b: int, n_cap: int, l_cap: int):
        """The DP scratch, one buffer grown to the largest group so far
        (None on the CPU, where the plain version keeps its own rows)."""
        if self.device.type != "cuda":
            return None
        need = kernels.poa_batch_scratch_bytes(b, n_cap, l_cap)
        if self._scratch is None or self._scratch.numel() < need:
            self._scratch = None          # free before growing
            self._scratch = torch.empty(need, dtype=torch.uint8,
                                        device=self.device)
        return self._scratch

    def _align(self, states, active, n_cap: int, l_cap: int,
               params: poa.POAParams) -> BatchedAlignment:
        """One read step of a group: every active lane's graph and next
        read up, one launch, the result back on the host."""
        b = len(states)
        letters = np.zeros((b, n_cap), dtype=np.uint8)
        preds = np.full((b, n_cap, PMAX), -1, dtype=np.int16)
        n_nodes = np.zeros(b, dtype=np.int32)
        seq_arr = np.zeros((b, l_cap), dtype=np.uint8)
        seq_len = np.zeros(b, dtype=np.int32)
        for li in active:
            st = states[li]
            letters[li] = st.letter_arr
            preds[li] = st.pred_arr
            n_nodes[li] = st.n_nodes()
            raw = np.frombuffer(st.seqs[st.next_read].encode("ascii"),
                                dtype=np.uint8)
            seq_arr[li, : len(raw)] = raw
            seq_len[li] = len(raw)
        t0 = time.perf_counter()
        dev = [torch.from_numpy(x).to(self.device)
               for x in (letters, preds, n_nodes, seq_arr, seq_len)]
        res = poa_align_batch(*dev, match=params.match,
                              mismatch=params.mismatch, go=params.gap_open,
                              ge=params.gap_extend,
                              scratch=self._scratch_for(b, n_cap, l_cap))
        res = BatchedAlignment(*[x.cpu().numpy() for x in res])
        self.stats["t_align_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        return res

    def msa_many(self, all_seqs: List[List[str]],
                 params: poa.POAParams) -> List[List[str]]:
        """MSA for many packs in lockstep groups; LAST_STATS and ``stats``
        count each pack where it ran."""
        t_start = time.perf_counter()
        timed0 = self.stats["t_align_s"] + self.stats["t_fallback_s"]
        steps0 = self.stats["steps"]
        results: List[List[str]] = [None] * len(all_seqs)  # type: ignore
        counts = {k: 0 for k in ("device_packs", "fallback_packs",
                                 "device_bases", "host_bases")}

        # order packs by size so lanes in a group have similar shapes
        order = sorted(range(len(all_seqs)),
                       key=lambda i: max((len(s) for s in all_seqs[i]),
                                         default=0))
        queue = list(order)

        while queue:
            lmax0 = max((len(s) for s in all_seqs[queue[0]]), default=1)
            l_cap = _round_pow2(lmax0 + 1, 128)
            n_lanes = _lanes_for(
                _round_pow2(min(4 * lmax0 + 64, 3 * l_cap), 256), l_cap)
            # the group's LARGEST pack sets the shapes, but n_lanes above
            # was sized from its smallest (the queue is sorted ascending):
            # shrink until the real caps fit the budget
            while True:
                group = queue[:n_lanes]
                lmax = max(max((len(s) for s in all_seqs[i]), default=1)
                           for i in group)
                l_cap = _round_pow2(lmax + 1, 128)
                n_cap = _round_pow2(min(4 * lmax + 64, 3 * l_cap), 256)
                if n_lanes <= LANES or _lanes_for(n_cap, l_cap) >= n_lanes:
                    break
                n_lanes //= 2
            queue = queue[n_lanes:]
            states = [_LaneState(all_seqs[i], n_cap, l_cap) for i in group]
            if n_cap > RANK_CAP:
                # the packed traceback cannot address these ranks: the
                # whole group goes to the host aligner
                for st in states:
                    st.fallback = True
                n_cap = 0
            max_reads = max(len(s.seqs) for s in states)

            for _t in range(max_reads):
                if n_cap == 0:
                    break
                active = []
                for li, st in enumerate(states):
                    if st.fallback or st.next_read >= len(st.seqs):
                        continue
                    if not st.refresh_rank():
                        st.fallback = True
                        continue
                    active.append(li)
                if not active:
                    continue
                res = self._align(states, active, n_cap, l_cap, params)
                for li in active:
                    st = states[li]
                    s = st.seqs[st.next_read]
                    st.add_alignment(
                        alignment_to_host(res, li, st.rank_nodes, len(s)), s)

            for pi, st in zip(group, states):
                if st.fallback:
                    counts["fallback_packs"] += 1
                    n_dev = st.next_read
                    t0 = time.perf_counter()
                    while st.next_read < len(st.seqs):
                        s = st.seqs[st.next_read]
                        st.add_alignment(st.align_fallback(s, params), s)
                    self.stats["t_fallback_s"] += time.perf_counter() - t0
                    counts["host_bases"] += sum(
                        len(s) for s in st.seqs[n_dev:])
                    counts["device_bases"] += sum(
                        len(s) for s in st.seqs[:n_dev])
                else:
                    counts["device_packs"] += 1
                    counts["device_bases"] += sum(len(s) for s in st.seqs)
                results[pi] = st.msa()

        for k, v in counts.items():
            LAST_STATS[k] += v
            self.stats[k] += v
        LAST_STATS["steps"] += self.stats["steps"] - steps0
        timed = self.stats["t_align_s"] + self.stats["t_fallback_s"]
        self.stats["t_host_s"] += (time.perf_counter() - t_start
                                   - (timed - timed0))
        return results


def batched_msa(all_seqs: List[List[str]], params: poa.POAParams,
                engine: PackEngine,
                lockstep: Optional[LockstepRunner] = None,
                native: Optional[dict] = None) -> List[List[str]]:
    """MSA for many packs on the backend RATTLE_POA_BACKEND names (read on
    every call): the pack engine ``engine`` by default (packs over its
    capacity on the host aligner, overlapped with the device groups),
    ``lockstep`` on ``lockstep`` (a LockstepRunner on the engine's device
    when None), or ``native``: every pack on the host aligner, its packs
    and bases added to ``native`` when given."""
    backend = os.environ.get(BACKEND_ENV)
    if backend == "native":
        if native is not None:
            native["packs"] += len(all_seqs)
            native["bases"] += sum(len(s) for seqs in all_seqs for s in seqs)
        return [_host_msa(seqs, params) for seqs in all_seqs]
    if backend == "lockstep":
        if lockstep is None:
            lockstep = LockstepRunner(engine.device)
        return lockstep.msa_many(all_seqs, params)
    results = engine.msa_many(
        all_seqs, match=params.match, mismatch=params.mismatch,
        go=params.gap_open, ge=params.gap_extend,
        host_fn=lambda seqs: _host_msa(seqs, params))
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise RuntimeError(f"pack engine returned no MSA for packs {missing}")
    LAST_STATS.update(engine.stats)
    return results


def _poa_params(p: CorrectParams) -> poa.POAParams:
    return poa.POAParams(p.poa_match, p.poa_mismatch, p.poa_gap_open,
                         p.poa_gap_extend)


class PackRunner:
    """The ``pack_runner`` hook of ``correct_reads`` on one device:
    two-round correction with device-batched MSAs across packs.  Its
    ``batch_msa`` serves correct_reads' final-consensus pass; ``engine``
    (PackEngine), ``lockstep`` (a LockstepRunner, made when
    RATTLE_POA_BACKEND=lockstep first chooses it, else None) and ``native``
    ({"packs", "bases"} of the native backend) account the run."""

    def __init__(self, device="cuda"):
        self.device = device
        self.engine = PackEngine(device=device)
        self.lockstep: Optional[LockstepRunner] = None
        self.native = {"packs": 0, "bases": 0}

    def _msas(self, all_seqs: List[List[str]], params: poa.POAParams):
        if os.environ.get(BACKEND_ENV) == "lockstep" and self.lockstep is None:
            self.lockstep = LockstepRunner(device=self.device)
        return batched_msa(all_seqs, params, self.engine, self.lockstep,
                           self.native)

    def __call__(self, packs, p: CorrectParams, msa_fn):
        params = _poa_params(p)
        msas = self._msas([[r.seq for r in pk.reads] for pk in packs], params)
        round2_inputs: List[Tuple[List[Read], List[Read], List[Read]]] = []
        for pk, msa in zip(packs, msas):
            fix_msa_ends(pk.reads, msa)
            corrected, uncorrected, _cv = correct_read_pack(
                pk.reads, msa, p.min_occ, p.gap_occ, p.err_ratio)
            second = [Read(r.header, r.seq, r.ann, r.quality)
                      for r in corrected]
            sort_read_set(second)
            round2_inputs.append((corrected, uncorrected, second))

        msas2 = self._msas([[r.seq for r in second]
                            for _, _, second in round2_inputs], params)
        outcomes = []
        for (corrected, uncorrected, second), msa2 in zip(round2_inputs,
                                                          msas2):
            fix_msa_ends(second, msa2)
            cv = generate_consensus_vector(second, msa2)
            outcomes.append((corrected, uncorrected, cv.consensus_string()))
        return outcomes

    def batch_msa(self, all_seqs: List[List[str]], p: CorrectParams):
        """Device-batched MSAs for correct_reads' final-consensus pass."""
        return self._msas(all_seqs, _poa_params(p))


def make_pack_runner(device="cuda") -> PackRunner:
    """The ``pack_runner`` hook for ``correct_reads`` on ``device``."""
    return PackRunner(device)
