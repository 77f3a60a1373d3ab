"""Device-resident POA pack engine: the whole per-pack read loop runs on the
device, one kernel launch per read step, and no graph state crosses to the
host until the final MSA download.

Port of rattle_tpu/correct/pack_engine.py.  The graph lives on the device in
node-id space and every step is:

    rank-space inputs (gathers through perm / node_rank)  ->  poa_align
      ->  vectorized alignment threading (scatters; all conflict-free)
      ->  incremental re-rank (key assignment + one stable sort)

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
* the kernel takes predecessor *rows*, gathered here through node_rank,
  instead of translating nodes through a rank table inside the kernel;
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
from ..ops.kernels import POA_PMAX as PMAX
from ..ops.kernels import poa_align, poa_scratch_elems

GA = 8                     # aligned-group member cap (distinct letters)
BIG = 2 ** 30
# key stride for the incremental re-rank.  run_idx is clipped to HALF-1 =
# SK-2, so for the W=4096 config the last two nodes of a maximal-length run
# share a key; the stable sort then orders them by node id, which equals
# path order for nodes created left-to-right in one read, so the collision
# resolves to the correct order by construction.
SK = 4096
HALF = SK - 1
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


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather over axis 1 with arbitrary trailing idx dims."""
    b = arr.shape[0]
    return torch.gather(arr, 1, idx.reshape(b, -1).long()).reshape(idx.shape)


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, M, K], idx [B, L] -> [B, L, K]."""
    return torch.gather(
        arr, 1, idx.long()[:, :, None].expand(-1, -1, arr.shape[2]))


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


def rank_space(st: dict):
    """Rank-space inputs of ``poa_align`` from the node-space state:
    (pred_rows [B, N, PMAX], npred [B, N], letters [B, N]) in rank order.
    Predecessor nodes become DP rows (rank + 1) through node_rank; an empty
    slot, and so slot 0 of a node without predecessors, is the virtual start
    row 0."""
    n = st["node_rank"].shape[1]
    perm_c = st["perm"][:, :n].clamp(0, n - 1)
    letters_r = _take(st["letters"], perm_c)
    npred_r = _take(st["npred"], perm_c).clamp(min=1)
    preds_r = _take_rows(st["preds"], perm_c)
    pred_rows = torch.where(
        preds_r >= 0, _take(st["node_rank"], preds_r.clamp(min=0)) + 1, 0)
    return pred_rows.to(torch.int32), npred_r, letters_r


def _step(st: dict, t: int, w_eff: Optional[int] = None, match: int = 5,
          mismatch: int = -4, go: int = -8, ge: int = -6,
          scratch: Optional[torch.Tensor] = None) -> dict:
    """Align read ``t`` of every lane and thread it into its graph.  Updates
    ``st`` in place and returns it."""
    seqs, lens = st["seqs"], st["lens"]
    letters, npred, preds = st["letters"], st["npred"], st["preds"]
    n_nodes = st["n_nodes"]
    grp_leader, member_idx = st["grp_leader"], st["member_idx"]
    grp_size, members, grp_pos = st["grp_size"], st["members"], st["grp_pos"]
    n_groups, perm = st["n_groups"], st["perm"]
    path, fallback = st["path"], st["fallback"]

    i32 = torch.int32
    dev = letters.device
    b, n = st["node_rank"].shape
    # effective column count for THIS step: the DP row cost is ~linear in
    # w, and pack reads arrive length-descending (the global length sort
    # orders cluster members), so later steps run at narrower widths
    w = seqs.shape[2] if w_eff is None else w_eff
    iota_n = torch.arange(n, dtype=i32, device=dev)[None, :]
    iota_w = torch.arange(w, dtype=i32, device=dev)[None, :]
    ones_w = torch.ones((b, w), dtype=i32, device=dev)

    active = (t < st["n_reads"]) & (fallback == 0)
    seq_u8 = seqs[:, t, :w].contiguous()
    seq = seq_u8.to(i32)                              # [B, W] char at p
    slen = lens[:, t].contiguous()

    pred_rows, npred_r, letters_r = rank_space(st)
    packed, tlen, best = poa_align(
        pred_rows, npred_r, letters_r, n_nodes, seq_u8, slen,
        active.to(i32), match=match, mismatch=mismatch, go=go, ge=ge,
        scratch=scratch)
    aligned = (best > 0) & (n_nodes > 0)

    # ---- decode: per-base matched rank -> node ----
    perm_c = perm[:, :n].clamp(0, n - 1)
    iota_t = torch.arange(packed.shape[1], dtype=i32, device=dev)[None, :]
    pos = (packed & 0xFFFF) - 1
    rk = (packed >> 16) - 1
    val = (iota_t < tlen[:, None]) & (pos >= 0) & aligned[:, None]
    m_rank = torch.full((b, w + 1), -1, dtype=i32, device=dev).scatter_(
        1, torch.where(val, pos, w).long(), rk)[:, :w]
    m_node = torch.where(m_rank >= 0, _take(perm_c, m_rank.clamp(0, n - 1)),
                         -1)

    basevalid = iota_w < slen[:, None]
    m_letter = _take(letters, m_node.clamp(0, n - 1))
    direct = (m_node >= 0) & (m_letter == seq)
    leader = _take(grp_leader, m_node.clamp(0, n - 1))
    gsz = _take(grp_size, leader.clamp(0, n - 1))
    mem = _take_rows(members, leader.clamp(0, n - 1))
    mem_letters = _take(letters, mem.clamp(0, n - 1))
    iota_g = torch.arange(GA, dtype=i32, device=dev)[None, None, :]
    mem_ok = (iota_g < gsz[:, :, None]) & (mem_letters == seq[:, :, None]) \
        & (mem >= 0)
    has_mem = mem_ok.any(dim=2) & (m_node >= 0) & ~direct
    # argmax of 0/1 values: the first member with the read's letter
    first_ok = mem_ok.to(torch.int8).argmax(dim=2, keepdim=True)
    join_node = torch.gather(mem, 2, first_ok)[:, :, 0]
    matched = torch.where(direct, m_node, torch.where(has_mem, join_node, -1))
    isnew = basevalid & (matched < 0)
    new_cnt = torch.cumsum(isnew, dim=1, dtype=i32)
    new_id = n_nodes[:, None] + new_cnt - 1
    target = torch.where(isnew, new_id, matched)
    target = torch.where(basevalid, target, -1)
    purenew = isnew & (m_node < 0)
    joiner = isnew & (m_node >= 0)

    n_new = new_cnt[:, -1]
    overflow_nodes = n_nodes + n_new > n

    ok = active & ~overflow_nodes
    wmask = basevalid & ok[:, None]

    # ---- apply threading (conflict-free scatters; masked writes land in
    # the spare slot n) ----
    t_or_n = torch.where(wmask & isnew, target, n).long()
    letters.scatter_(1, t_or_n, seq)
    grp_leader.scatter_(1, t_or_n, torch.where(purenew, target, leader))
    member_idx.scatter_(1, t_or_n, torch.where(purenew, 0, gsz))
    p_or_n = torch.where(wmask & purenew, target, n).long()
    grp_size.scatter_(1, p_or_n, ones_w)
    members_flat = members.view(b, -1)
    members_flat.scatter_(1, p_or_n * GA, target)
    j_or_n = torch.where(wmask & joiner, leader, n).long()
    grp_overflow = (wmask & joiner & (gsz >= GA)).any(dim=1)
    members_flat.scatter_(1, j_or_n * GA + gsz.clamp(0, GA - 1).long(),
                          torch.where(gsz < GA, target, -1))
    grp_size.scatter_add_(1, j_or_n, ones_w)

    prevt = torch.nn.functional.pad(target[:, :-1], (1, 0), value=-1)
    em = wmask & (iota_w >= 1) & (prevt >= 0) & (prevt != target)
    tgt_c = target.clamp(0, n - 1)
    tpred = _take_rows(preds, tgt_c)
    npr_t = _take(npred, tgt_c)
    iota_p = torch.arange(PMAX, dtype=i32, device=dev)[None, None, :]
    exists = ((tpred == prevt[:, :, None])
              & (iota_p < npr_t[:, :, None])).any(dim=2)
    add = em & ~exists
    pred_overflow = (add & (npr_t >= PMAX)).any(dim=1)
    a_or_n = torch.where(add, target, n).long()
    preds.view(b, -1).scatter_(
        1, a_or_n * PMAX + npr_t.clamp(0, PMAX - 1).long(),
        torch.where(npr_t < PMAX, prevt, -1))
    npred.scatter_add_(1, a_or_n, ones_w)

    tot = path.shape[1] - 1
    pidx = torch.where(wmask, st["offsets"][:, t, None] + iota_w, tot)
    path.scatter_(1, pidx.long(), target)

    # ---- incremental re-rank ----
    lead_all = torch.where(purenew, target, leader)
    lead_all = torch.where(isnew, lead_all,
                           _take(grp_leader, matched.clamp(0, n - 1)))
    placed = wmask & ~purenew
    gpos_t = _take(grp_pos, lead_all.clamp(0, n - 1))
    gmark = torch.where(placed, gpos_t, BIG)
    gnext = torch.flip(torch.cummin(torch.flip(gmark, [1]), dim=1).values,
                       [1])
    gnextf = torch.where(gnext >= BIG, n_groups[:, None], gnext)
    lastp = torch.cummax(torch.where(placed, iota_w, -1), dim=1).values
    run_idx = iota_w - lastp - 1
    key_new = gnextf * SK + run_idx.clamp(0, HALF - 1)

    is_leader = grp_leader[:, :n] == iota_n
    keys = torch.full((b, n + 1), BIG, dtype=i32, device=dev)
    keys[:, :n] = torch.where(is_leader & (iota_n < n_nodes[:, None]),
                              grp_pos[:, :n] * SK + HALF, BIG)
    keys.scatter_(1, p_or_n, key_new.to(i32))

    # stable: equal keys (see SK) must keep node-id order
    order = torch.sort(keys[:, :n], dim=1, stable=True).indices
    gsz_s = torch.gather(grp_size, 1, order)
    n_groups_new = torch.where(
        ok, n_groups + (purenew & wmask).sum(dim=1).to(i32), n_groups)
    n_nodes_new = torch.where(ok, n_nodes + n_new, n_nodes)
    live_pos = iota_n < n_groups_new[:, None]
    iota_bn = iota_n.expand(b, n).contiguous()
    grp_pos.scatter_(1, torch.where(live_pos, order, n), iota_bn)
    sz_sorted = torch.where(live_pos, gsz_s, 0)
    starts = torch.cumsum(sz_sorted, dim=1, dtype=i32) - sz_sorted
    posn = _take(grp_pos, grp_leader[:, :n].clamp(0, n - 1))
    rank_new = _take(starts, posn.clamp(0, n - 1)) + member_idx[:, :n]
    valid_node = iota_n < n_nodes_new[:, None]
    node_rank = torch.where(valid_node, rank_new, n).to(i32)
    perm.scatter_(1, node_rank.long(), iota_bn)
    fallback = fallback | torch.where(
        active,
        overflow_nodes.to(i32) + (pred_overflow.to(i32) << 1)
        + (grp_overflow.to(i32) << 2), 0)

    st.update(n_nodes=n_nodes_new, n_groups=n_groups_new,
              node_rank=node_rank, fallback=fallback)
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
                t0 = time.time()
                for i, fut in futures.items():
                    results[i] = fut.result()
                self.stats["host_wait_s"] = round(
                    self.stats.get("host_wait_s", 0.0) + time.time() - t0, 2)
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
                                    + time.time() - t0, 2)
            return time.time()

        w, n_cap = group[0][0]
        ids = [i for _, _, i in group]
        b = len(ids)
        r_max = max(len(all_seqs[i]) for i in ids)
        tmark = time.time()
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
