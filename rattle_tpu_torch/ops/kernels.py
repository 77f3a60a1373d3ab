"""The port's kernels, each beside its plain PyTorch version.

The three counterparts of the JAX package's Pallas kernels:

* ``bv_common``  -- csrc/bv_common.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::bv_common_matmul.
* ``lis_filter`` -- csrc/lis_filter.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::lis_filter_pallas.
* ``poa_align``  -- csrc/poa_align.cu, replaces
  rattle_tpu/ops/poa_pallas.py::poa_align_pallas.

and the kernels of ``cluster``'s score path, the parts of the JAX package's
jitted programs that ran as eager launch chains:

* ``join_expand``  -- csrc/join_expand.cu: the table gathers and the join of
  rattle_tpu/cluster/bulk.py::_score_body (merge_join_expand /
  sorted_join_expand of rattle_tpu/ops/join_device.py).
* ``score_decide`` -- csrc/score_decide.cu: the decision half of _score_body.
* ``greedy_owner`` -- csrc/greedy_owner.cu: rattle_tpu/cluster/bulk.py::
  greedy_owner, the block replay.
* ``gate_block``   -- csrc/gate_block.cu (a persistent pass 1 on wgmma over
  csrc/bv_tile.cuh's stages, one host read, pass 2 a warp a row):
  rattle_tpu/cluster/bulk.py::gate_class_block, the gate with its cache
  fold, class routing and pair compaction.
* ``absorb_rest``  -- csrc/absorb_rest.cu: rattle_tpu/cluster/bulk.py::
  absorb_rest, the sweep replay.

and the two kernels of ``correct``'s read step after ``poa_align``, the rest
of rattle_tpu/correct/pack_engine.py::_step:

* ``poa_thread`` -- csrc/poa_thread.cu: the alignment's moves decoded and
  threaded into each lane's graph, and the keys of the re-rank.
* ``poa_rerank`` -- csrc/poa_rerank.cu: the incremental re-rank and the next
  step's rank-space inputs of ``poa_align``.

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and takes the
plain version only because its tensors lie on the CPU; there is no fallback
from one to the other.  Each wrapper counts its kernel launches in a plain
integer attribute (``bv_common.launches``, ``join_expand.launches``, ...) so
a run can show that a path went through the kernel; ``lis_filter.shapes``
splits its count by (M, B).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _ext
from . import join_device
from .lis_select import (anchor_filter_select, lis_build_select,
                         lis_reconstruct_select)
from .similarity import variance

BV_WORDS = 128          # 4096-bit vectors, packed
BV_BITS = BV_WORDS * 32
# longest match list lis_filter takes: int16 match indices, and one pair's
# state (16 bytes a slot) within a block's shared memory on the card
LIS_MAX_M = 8192


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device, width: Optional[int] = None) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: expected {ndim}-d {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if width is not None and t.shape[-1] != width:
        raise ValueError(f"{name}: expected last dim {width}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# --------------------------------------------------------------------------
# bitvector gate: popcount(AND) for every (pool, seed) pair
# --------------------------------------------------------------------------


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[N, 128] int32 packed words -> [N, 4096] uint8 bit plane, bit h at
    column h (word h >> 5, bit h & 31: ops/sketch.py _pack_bv order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], BV_BITS).to(torch.uint8)


def bv_common_plain(pool: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack both sides to 0/1 planes and contract them in
    float32 (exact: every partial sum is an integer <= 4096 < 2^24)."""
    a = unpack_bits(pool).to(torch.float32)
    b = unpack_bits(seed).to(torch.float32)
    return (a @ b.T).to(torch.int32)


def bv_common(pool: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """pool [P, 128] int32, seed [S, 128] int32 -> [P, S] int32 counts of
    common set bits.  Zero rows are inert; no shape padding is needed."""
    dev = pool.device
    _check("bv_common pool", pool, torch.int32, 2, dev, BV_WORDS)
    _check("bv_common seed", seed, torch.int32, 2, dev, BV_WORDS)
    if not _on_card(pool):
        return bv_common_plain(pool, seed)
    if pool.data_ptr() % 16 or seed.data_ptr() % 16:
        raise ValueError("bv_common: rows must be 16-byte aligned (cp.async "
                         "of 16-byte units)")
    p, s = pool.shape[0], seed.shape[0]
    out = torch.empty((p, s), dtype=torch.int32, device=dev)
    if p == 0 or s == 0:
        return out
    fn = _ext.load("bv_common").bv_common_launch
    _raise_on(fn(pool.data_ptr(), seed.data_ptr(), out.data_ptr(), p, s,
                 _stream(dev)), "bv_common")
    bv_common.launches += 1
    return out


bv_common.launches = 0


# --------------------------------------------------------------------------
# fused LIS + anchor filter + variance
# --------------------------------------------------------------------------


def lis_filter_plain(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                     kmer_size: int, hc_max_dist: int = 10,
                     bound: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain version: the select scans of ops/lis_select.py and the variance
    of ops/similarity.py.  ``bound`` truncates the scans at the first
    ``bound`` match slots, as the kernel does."""
    if bound is not None:
        m = max(0, min(int(bound.reshape(-1)[0]), p1.shape[1]))
        p1, p2, valid = p1[:, :m], p2[:, :m], valid[:, :m]
    p_pred, m_idx, l = lis_build_select(p2, valid)
    s_arr = lis_reconstruct_select(p_pred, m_idx, l).to(torch.int64)
    a1 = torch.gather(p1, 1, s_arr)
    a2 = torch.gather(p2, 1, s_arr)
    bases, hc, kept, dist_arr = anchor_filter_select(a1, a2, l, kmer_size,
                                                     hc_max_dist)
    n_dist = torch.clamp(kept - 1, min=0)
    return bases, hc, n_dist, variance(dist_arr, n_dist)


def lis_filter(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
               kmer_size: int, hc_max_dist: int = 10,
               bound: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """Fused LIS + filter + variance for [B, M] match lists sorted by
    (p1, p2): p1, p2 int32, valid bool, M <= LIS_MAX_M.  Returns (bases,
    hc, n_dist [B] int32, var [B] float32).

    ``bound``: optional int32 scalar tensor on the same device, the largest
    valid match count of the batch; all three scans stop there (exact when
    it is that maximum).  The kernel reads it on the device, so passing it
    costs no host sync."""
    dev = p1.device
    _check("lis_filter p1", p1, torch.int32, 2, dev)
    _check("lis_filter p2", p2, torch.int32, 2, dev, p1.shape[1])
    _check("lis_filter valid", valid, torch.bool, 2, dev, p1.shape[1])
    if p2.shape[0] != p1.shape[0] or valid.shape[0] != p1.shape[0]:
        raise ValueError("lis_filter: p1, p2 and valid must share [B, M]")
    if p1.shape[1] > LIS_MAX_M:
        raise ValueError(f"lis_filter: M must be at most {LIS_MAX_M}, got "
                         f"{p1.shape[1]}")
    if bound is not None:
        _check("lis_filter bound", bound.reshape(-1), torch.int32, 1, dev, 1)
    if not _on_card(p1):
        return lis_filter_plain(p1, p2, valid, kmer_size, hc_max_dist, bound)
    b, m = p1.shape
    if bound is None:
        bound = torch.full((1,), m, dtype=torch.int32, device=dev)
    bound = bound.reshape(1).contiguous()
    bases = torch.empty((b,), dtype=torch.int32, device=dev)
    hc = torch.empty_like(bases)
    n_dist = torch.empty_like(bases)
    var = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return bases, hc, n_dist, var
    fn = _ext.load("lis_filter").lis_filter_launch
    _raise_on(fn(p1.data_ptr(), p2.data_ptr(), valid.data_ptr(),
                 bound.data_ptr(), b, m, kmer_size, hc_max_dist,
                 bases.data_ptr(), hc.data_ptr(), n_dist.data_ptr(),
                 var.data_ptr(), _stream(dev)), "lis_filter")
    lis_filter.launches += 1
    lis_filter.shapes[(m, b)] = lis_filter.shapes.get((m, b), 0) + 1
    return bases, hc, n_dist, var


lis_filter.launches = 0
# launches by (M, B): the split of lis_filter.launches over tiers and chunks
lis_filter.shapes = {}


# --------------------------------------------------------------------------
# POA alignment: one read per lane against a graph in rank order + traceback
# --------------------------------------------------------------------------

POA_PMAX = 16           # predecessor slots per rank
POA_NEG = -(2 ** 30)
POA_MAX_W = 4096


def poa_scratch_elems(b: int, n: int, w: int) -> int:
    """int16 elements of DP scratch ``poa_align`` needs on the card: the H,
    F and direction rows of [b, n + 1, w] each."""
    return 3 * b * (n + 1) * w


def _shift1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Column j takes column j - 1; column 0 takes ``fill``."""
    first = torch.full_like(x[:, :1], fill)
    return torch.cat([first, x[:, :-1]], dim=1)


def poa_align_plain(pred_rows: torch.Tensor, npred: torch.Tensor,
                    letters: torch.Tensor, n_nodes: torch.Tensor,
                    seq: torch.Tensor, seq_len: torch.Tensor, step: int,
                    n_reads: torch.Tensor, fallback: torch.Tensor,
                    match: int = 5, mismatch: int = -4, go: int = -8,
                    ge: int = -6, scratch: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the recurrences of ops/poa.py::align_local row by row
    over all lanes at once (int32 rows, cummax for the E prefix maximum),
    then the H/E/F traceback as a batched state machine.  ``scratch`` is
    not used."""
    dev = letters.device
    i32 = torch.int32
    b, n = letters.shape
    w = seq.shape[1]
    bidx = torch.arange(b, device=dev)
    active = (step < n_reads) & (fallback == 0)
    nn = torch.where(active, n_nodes.clamp(max=n), 0)
    rows = int(nn.max()) if b else 0
    cs = torch.arange(w, dtype=i32, device=dev)[None, :]
    slen = seq_len.clamp(max=w - 1)[:, None]
    colmask = (cs >= 1) & (cs <= slen)
    seq_sh = _shift1(seq.to(i32), 0)          # column j holds base j - 1
    pr_all = pred_rows.clamp(min=0).long()

    h_rows = torch.zeros((b, rows + 1, w), dtype=i32, device=dev)
    f_rows = torch.full((b, rows + 1, w), POA_NEG, dtype=i32, device=dev)
    d_rows = torch.zeros((b, rows + 1, w), dtype=i32, device=dev)
    bv = torch.zeros((b, w), dtype=i32, device=dev)
    brv = torch.zeros((b, w), dtype=i32, device=dev)
    zero = torch.zeros((b, w), dtype=i32, device=dev)
    neg = torch.full((b, w), POA_NEG, dtype=i32, device=dev)

    for r in range(rows):
        x = r + 1
        live = (r < nn)[:, None]
        np_r = torch.where(live[:, 0], npred[:, r].clamp(1, POA_PMAX), 1)
        a_h, arg_h, b_f, arg_f, ext_f = neg, zero, neg, zero, zero
        for k in range(int(np_r.max())):
            pr = pr_all[:, r, k]
            pr = torch.where(pr > r, 0, pr)   # only earlier rows exist
            use = (k < np_r)[:, None]
            hl, fl = h_rows[bidx, pr], f_rows[bidx, pr]
            ho, fe = hl + go, fl + ge
            fk = torch.maximum(ho, fe)
            hgt = (hl > a_h) & use            # strict: the first maximum wins
            fgt = (fk > b_f) & use
            a_h = torch.where(hgt, hl, a_h)
            arg_h = torch.where(hgt, k, arg_h)
            b_f = torch.where(fgt, fk, b_f)
            arg_f = torch.where(fgt, k, arg_f)
            ext_f = torch.where(fgt, (fe >= ho).to(i32), ext_f)
        sub = torch.where(seq_sh == letters[:, r, None], match, mismatch)
        sub = torch.where(colmask, sub, POA_NEG).to(i32)
        diag = _shift1(a_h, POA_NEG) + sub
        arg_diag = _shift1(arg_h, 0)
        f = torch.where(cs >= 1, b_f, POA_NEG)
        a = torch.maximum(torch.maximum(diag, f), zero)
        # E[j] = ge*j + max_{j' < j}(A[j'] + go - ge*(j'+1))
        run = torch.cummax(a + go - ge * (cs + 1), dim=1).values
        e = torch.where(cs >= 1, ge * cs + _shift1(run, POA_NEG), POA_NEG)
        h = torch.maximum(a, e)
        dir_h = torch.where(e == h, POA_PMAX + 2, 0)
        dir_h = torch.where(f == h, POA_PMAX + 1, dir_h)
        dir_h = torch.where(diag == h, 1 + arg_diag, dir_h)
        dir_h = torch.where(h == 0, 0, dir_h)
        e_ext = ((e == _shift1(e, POA_NEG) + ge) & (cs >= 1)).to(i32)
        h_rows[:, x] = h
        f_rows[:, x] = f
        d_rows[:, x] = dir_h | (arg_f << 5) | (ext_f << 9) | (e_ext << 10)
        upd = (h > bv) & live
        bv = torch.where(upd, h, bv)
        brv = torch.where(upd, x, brv)

    # first maximum in (row, column) order
    big = 2 ** 30
    best = bv.max(dim=1).values if w else torch.zeros(b, dtype=i32, device=dev)
    cand = bv == best[:, None]
    r = torch.where(cand, brv, big).min(dim=1).values
    j = torch.where(cand & (brv == r[:, None]), cs, big).min(dim=1).values
    state = torch.where(best > 0, 0, 3)       # 0 = H, 1 = E, 2 = F, 3 = done
    r = torch.where(best > 0, r, 0)
    j = torch.where(best > 0, j, 0)
    t = torch.zeros(b, dtype=i32, device=dev)
    packed = torch.zeros((b, w + 1), dtype=i32, device=dev)
    for _ in range(2 * (rows + w) + 4):
        if not bool((state < 3).any()):
            break
        d = d_rows[bidx, r.long(), j.long()]
        rm1 = (r - 1).clamp(0, n - 1).long()
        dh = d & 31
        stop = (r == 0) | (dh == 0)
        is_diag = (dh >= 1) & (dh <= POA_PMAX) & ~stop
        pr_h = pred_rows[bidx, rm1, (dh - 1).clamp(0, POA_PMAX - 1).long()]
        pr_f = pred_rows[bidx, rm1, ((d >> 5) & 15).long()]
        in_h, in_e = state == 0, state == 1
        ns_h = torch.where(stop, 3, torch.where(
            is_diag, 0, torch.where(dh == POA_PMAX + 2, 1, 2)))
        ns = torch.where(in_h, ns_h, torch.where(
            in_e, (d >> 10) & 1, ((d >> 9) & 1) * 2))
        nr = torch.where(in_h, torch.where(is_diag, pr_h, r),
                         torch.where(in_e, r, pr_f))
        nj = torch.where(in_h, torch.where(is_diag, j - 1, j),
                         torch.where(in_e, j - 1, j))
        stale = (state == 3) | (t >= w)
        emit = in_h & is_diag & ~stale
        packed[bidx, torch.where(emit, t, w).long()] = (r << 16) | j
        state = torch.where(stale, state, ns).to(i32)
        r = torch.where(stale, r, nr.clamp(0, rows)).to(i32)
        j = torch.where(stale, j, nj.clamp(0, w - 1)).to(i32)
        t = t + emit.to(i32)
    return packed[:, :w].contiguous(), t, best.to(i32)


def poa_align(pred_rows: torch.Tensor, npred: torch.Tensor,
              letters: torch.Tensor, n_nodes: torch.Tensor,
              seq: torch.Tensor, seq_len: torch.Tensor, step: int,
              n_reads: torch.Tensor, fallback: torch.Tensor,
              match: int = 5, mismatch: int = -4, go: int = -8, ge: int = -6,
              scratch: Optional[torch.Tensor] = None,
              stamps: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local affine-gap alignment of one read per lane against its graph in
    topological-rank order (the semantics of ops/poa.py::align_local).

    Rank-space inputs, int32 unless noted: ``pred_rows`` [B, N, 16], the DP
    row of predecessor k of rank r in edge-insertion order (0 = the virtual
    start row, else rank + 1; slot 0 is 0 for a rank without predecessors);
    ``npred`` [B, N] >= 1; ``letters`` [B, N]; ``n_nodes`` [B]; ``seq``
    [B, W] uint8, base p at column p, W a multiple of 128 up to 4096 (the
    step's width, a runtime value), unit column stride and any row stride
    (the pack's ``seqs[:, t, :W]`` is read in place); ``seq_len`` [B] <= W -
    2, any stride.  A lane aligns at the pack engine's read step ``step``
    while step < ``n_reads`` [B] and ``fallback`` [B] == 0 (both read on the
    card); a lone alignment passes step 0, n_reads 1 and fallback 0.

    Returns (packed [B, W], count [B], best [B]): the traceback's diagonal
    moves as (rank + 1) << 16 | (pos + 1) in reverse order, their number,
    and the best score; packed entries from count on are undefined.  An
    inactive lane or an empty graph gives count 0 and best 0.

    ``scratch``: optional 1-d int16 tensor on the same device with at least
    ``poa_scratch_elems(B, N, W)`` elements, reused across calls; the kernel
    keeps its H, F and direction rows there.

    ``stamps``: on the card only, an optional int64 [B, 3] tensor that takes
    each lane's start, end of the DP rows and end of the traceback on the
    card's nanosecond timer: chip_smoke.py's probe of the DP / traceback
    split; the port's own calls pass none."""
    dev = letters.device
    _check("poa_align letters", letters, torch.int32, 2, dev)
    b, n = letters.shape
    _check("poa_align npred", npred, torch.int32, 2, dev, n)
    _check("poa_align pred_rows", pred_rows, torch.int32, 3, dev, POA_PMAX)
    _check_table("poa_align seq", seq, torch.uint8, dev)
    w = seq.shape[1]
    _check("poa_align n_nodes", n_nodes, torch.int32, 1, dev, b)
    if (seq_len.dtype != torch.int32 or seq_len.dim() != 1
            or seq_len.device != dev or seq_len.shape[0] != b):
        raise ValueError(f"poa_align seq_len: expected int32 [{b}] on {dev}")
    _check("poa_align n_reads", n_reads, torch.int32, 1, dev, b)
    _check("poa_align fallback", fallback, torch.int32, 1, dev, b)
    if (npred.shape[0] != b or seq.shape[0] != b
            or tuple(pred_rows.shape[:2]) != (b, n)):
        raise ValueError("poa_align: inputs must share [B, N]")
    if w < 128 or w > POA_MAX_W or w % 128 or n < 1:
        raise ValueError(f"poa_align: W must be a multiple of 128 in "
                         f"[128, {POA_MAX_W}] and N >= 1, got W={w} N={n}")
    if not _on_card(letters):
        return poa_align_plain(pred_rows, npred, letters, n_nodes, seq,
                               seq_len, step, n_reads, fallback, match,
                               mismatch, go, ge)
    need = poa_scratch_elems(b, n, w)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.int16, device=dev)
    else:
        _check("poa_align scratch", scratch, torch.int16, 1, dev)
        if scratch.numel() < need:
            raise ValueError(f"poa_align: scratch has {scratch.numel()} "
                             f"elements, needs {need}")
    packed = torch.empty((b, w), dtype=torch.int32, device=dev)
    tlen = torch.empty((b,), dtype=torch.int32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return packed, tlen, best
    if stamps is not None:
        _check("poa_align stamps", stamps, torch.int64, 2, dev, 3)
        if stamps.shape[0] != b:
            raise ValueError("poa_align: stamps must be [B, 3]")
    plane = 2 * b * (n + 1) * w               # bytes of one int16 plane
    base = scratch.data_ptr()
    fn = _ext.load("poa_align").poa_align_launch
    _raise_on(fn(pred_rows.data_ptr(), npred.data_ptr(), letters.data_ptr(),
                 n_nodes.data_ptr(), seq.data_ptr(), seq_len.data_ptr(),
                 n_reads.data_ptr(), fallback.data_ptr(), step,
                 _row_stride(seq), seq_len.stride(0), b, n, w, match,
                 mismatch, go, ge,
                 base, base + plane, base + 2 * plane, packed.data_ptr(),
                 tlen.data_ptr(), best.data_ptr(),
                 None if stamps is None else stamps.data_ptr(),
                 _stream(dev)), "poa_align")
    poa_align.launches += 1
    return packed, tlen, best


poa_align.launches = 0

# --------------------------------------------------------------------------
# the lockstep runner's alignment: every move emitted, H/E/F stored
# --------------------------------------------------------------------------

POA_CLAMP16 = -16384
# longest read for which int16 cell storage is exact (ops/poa_device.py)
POA_SMALL_L = 3200
# a thread takes 4 columns and a CTA at most 1,024 threads
POA_BATCH_MAX_L = 4096
# the packed traceback keeps rank + 1 in 16 bits
POA_BATCH_MAX_N = 32767
POA_BATCH_MAX_P = 8


def poa_batch_scratch_bytes(b: int, n: int, l: int) -> int:
    """Bytes of DP scratch ``poa_align_batch`` needs on the card: the H, E
    and F cells of [b, n + 1, l + 1], int16 for l <= POA_SMALL_L and int32
    above."""
    return 3 * b * (n + 1) * (l + 1) * (2 if l <= POA_SMALL_L else 4)


def poa_align_batch_plain(letters: torch.Tensor, preds: torch.Tensor,
                          n_nodes: torch.Tensor, seq: torch.Tensor,
                          seq_len: torch.Tensor, match: int = 5,
                          mismatch: int = -4, go: int = -8, ge: int = -6
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version: rattle_tpu/ops/poa_device.py::poa_align_batch line
    for line, the rank scan a loop over [B, L + 1] rows (cummax for E) and
    the traceback a batched state machine.  Rows past the largest n_nodes
    are not built: there they are NEG, and no output reads them."""
    dev = letters.device
    i32 = torch.int32
    b, n = letters.shape
    l = seq.shape[1]
    preds = preds.to(i32)
    small = l <= POA_SMALL_L
    cell = torch.int16 if small else i32
    neg_store = POA_CLAMP16 if small else POA_NEG

    def store(x):
        return x.clamp(min=POA_CLAMP16).to(cell) if small else x

    rows = min(max(int(n_nodes.max()), 0), n) if b else 0
    h_all = torch.zeros((b, rows + 1, l + 1), dtype=cell, device=dev)
    e_all = torch.full((b, rows + 1, l + 1), neg_store, dtype=cell,
                       device=dev)
    f_all = torch.full((b, rows + 1, l + 1), neg_store, dtype=cell,
                       device=dev)
    jcols = torch.arange(l + 1, dtype=i32, device=dev)
    seq_valid = jcols[None, 1:] <= seq_len[:, None]
    seq_i = seq.to(i32)
    bidx = torch.arange(b, device=dev)
    for r in range(rows):
        letter = letters[:, r].to(i32)
        pred = preds[:, r]
        pred_ok = (pred >= 0)[:, :, None]
        pred_idx = pred.clamp(0, rows).long()
        hp = torch.where(pred_ok, h_all[bidx[:, None], pred_idx].to(i32),
                         POA_NEG)
        fp = torch.where(pred_ok, f_all[bidx[:, None], pred_idx].to(i32),
                         POA_NEG)
        sub = torch.where(seq_i == letter[:, None], match, mismatch)
        sub = torch.where(seq_valid, sub, POA_NEG)
        diag = hp[:, :, :-1].max(dim=1).values + sub
        f = torch.maximum(hp + go, fp + ge).max(dim=1).values
        f[:, 0] = POA_NEG
        a = f.clamp(min=0)
        a[:, 1:] = torch.maximum(a[:, 1:], diag)
        run = torch.cummax(a + go - ge * (jcols + 1)[None, :], dim=1).values
        e = torch.full((b, l + 1), POA_NEG, dtype=i32, device=dev)
        e[:, 1:] = ge * jcols[None, 1:] + run[:, :-1]
        h = torch.maximum(a, e)
        live = (r < n_nodes)[:, None]
        h_all[:, r + 1] = store(torch.where(live, h, POA_NEG))
        e_all[:, r + 1] = store(torch.where(live, e, POA_NEG))
        f_all[:, r + 1] = store(torch.where(live, f, POA_NEG))

    flat = h_all.reshape(b, -1)
    best = flat.argmax(dim=1)                       # first max, row-major
    best_r = (best // (l + 1)).to(i32)
    best_j = (best % (l + 1)).to(i32)
    aligned = flat.gather(1, best[:, None])[:, 0].to(i32) > 0

    tmax = n + l
    out = torch.zeros((b, tmax), dtype=i32, device=dev)
    out_len = torch.zeros(b, dtype=i32, device=dev)
    # states: 0 = H, 1 = E, 2 = F; done lanes have state 3
    state = torch.where(aligned, 0, 3).to(i32)
    r, j = best_r, best_j

    def at(arr, row, col):
        return arr[bidx, row.long(), col.long()].to(i32)

    def at_pred(arr, pidx, col):
        return arr[bidx[:, None], pidx, col.long()[:, None]].to(i32)

    for _ in range(tmax):
        if not bool((state < 3).any()):
            break
        jm1 = (j - 1).clamp(min=0)
        hrj, erj, frj = at(h_all, r, j), at(e_all, r, j), at(f_all, r, j)
        rr = (r - 1).clamp(0, n - 1).long()
        pred = preds[bidx, rr]
        pred_ok = pred >= 0
        pred_idx = pred.clamp(0, rows).long()
        hp_j = at_pred(h_all, pred_idx, j)
        hp_jm1 = at_pred(h_all, pred_idx, jm1)
        fp_j = at_pred(f_all, pred_idx, j)
        letter = letters[bidx, rr].to(i32)
        ch = seq_i[bidx, (j - 1).clamp(0, l - 1).long()]
        sub = torch.where(ch == letter, match, mismatch)

        in_h = state == 0
        stop = in_h & ((r == 0) | (hrj == 0))
        diag_eq = pred_ok & (hp_jm1 + sub[:, None] == hrj[:, None]) \
            & (j > 0)[:, None]
        any_diag = diag_eq.any(dim=1) & in_h & ~stop
        diag_pred = pred_idx[bidx, diag_eq.int().argmax(dim=1)].to(i32)
        take_f = in_h & ~stop & ~any_diag & (hrj == frj)
        take_e = in_h & ~stop & ~any_diag & ~take_f & (hrj == erj)

        in_e = state == 1
        e_can_ext = erj == at(e_all, r, jm1) + ge
        e_to_h = in_e & ~e_can_ext & (erj == at(h_all, r, jm1) + go)

        in_f = state == 2
        f_open = pred_ok & (hp_j + go == frj[:, None])
        f_ext = pred_ok & (fp_j + ge == frj[:, None])
        first_f = (f_open | f_ext).int().argmax(dim=1)
        f_pred = pred_idx[bidx, first_f].to(i32)
        f_is_open = f_open[bidx, first_f] & ~f_ext[bidx, first_f]

        emit_node = torch.where(any_diag | in_f, r, 0)
        emit_pos = torch.where(any_diag | in_e, j, 0)
        do_emit = (any_diag | take_e | take_f | in_e | in_f) & (state < 3)
        do_emit = do_emit & ~(take_e | take_f)
        slot = out_len.clamp(0, tmax - 1).long()
        out[bidx, slot] = torch.where(do_emit, (emit_node << 16) | emit_pos,
                                      out[bidx, slot])
        out_len = out_len + do_emit.to(i32)

        new_state = torch.where(stop, 3, state)
        new_r = torch.where(any_diag, diag_pred, r)
        new_j = torch.where(any_diag, j - 1, j)
        new_state = torch.where(take_e, 1, new_state)
        new_state = torch.where(take_f, 2, new_state)
        new_state = torch.where(in_e & e_to_h, 0, new_state)
        new_j = torch.where(in_e, j - 1, new_j)
        new_r = torch.where(in_f, f_pred, new_r)
        new_state = torch.where(in_f & f_is_open, 0, new_state)
        state, r, j = new_state.to(i32), new_r.to(i32), new_j.to(i32)
    return out, out_len, aligned


def poa_align_batch(letters: torch.Tensor, preds: torch.Tensor,
                    n_nodes: torch.Tensor, seq: torch.Tensor,
                    seq_len: torch.Tensor, match: int = 5,
                    mismatch: int = -4, go: int = -8, ge: int = -6,
                    scratch: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local affine-gap alignment of one read per lane against its graph in
    topological-rank order, every traceback move emitted (the contract of
    rattle_tpu/ops/poa_device.py::poa_align_batch).

    ``letters`` [B, N] uint8 raw characters; ``preds`` [B, N, P] int16 or
    int32, P <= 8: rank + 1 of each predecessor of a rank, 0 for the
    virtual start, -1 for padding, naming only earlier ranks; ``n_nodes``
    [B] int32; ``seq`` [B, L] uint8, 0-padded, L <= 4096 on the card;
    ``seq_len`` [B] int32.  Cells are stored as int16 clamped at
    POA_CLAMP16 when L <= POA_SMALL_L, else as int32, and read back so.

    Returns (packed [B, N + L] int32, length [B] int32, aligned [B] bool):
    the moves as (rank + 1) << 16 | (pos + 1) in reverse order, 0 in a half
    for a gap; entries from ``length`` on are undefined on the card.

    ``scratch``: optional 1-d uint8 tensor on the same device with at least
    ``poa_batch_scratch_bytes(B, N, L)`` bytes, reused across calls."""
    dev = letters.device
    _check("poa_align_batch letters", letters, torch.uint8, 2, dev)
    b, n = letters.shape
    if preds.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"poa_align_batch preds: expected int16 or int32, "
                         f"got {preds.dtype}")
    _check("poa_align_batch preds", preds, preds.dtype, 3, dev)
    _check("poa_align_batch n_nodes", n_nodes, torch.int32, 1, dev, b)
    _check("poa_align_batch seq", seq, torch.uint8, 2, dev)
    _check("poa_align_batch seq_len", seq_len, torch.int32, 1, dev, b)
    l, pmax = seq.shape[1], preds.shape[2]
    if tuple(preds.shape[:2]) != (b, n) or seq.shape[0] != b:
        raise ValueError("poa_align_batch: inputs must share [B, N]")
    if not (1 <= n <= POA_BATCH_MAX_N and l >= 1
            and 1 <= pmax <= POA_BATCH_MAX_P):
        raise ValueError(f"poa_align_batch: need 1 <= N <= "
                         f"{POA_BATCH_MAX_N}, L >= 1 and 1 <= P <= "
                         f"{POA_BATCH_MAX_P}, got N={n} L={l} P={pmax}")
    if not _on_card(letters):
        return poa_align_batch_plain(letters, preds, n_nodes, seq, seq_len,
                                     match, mismatch, go, ge)
    if l > POA_BATCH_MAX_L:
        raise ValueError(f"poa_align_batch: L must be at most "
                         f"{POA_BATCH_MAX_L} on the card, got {l}")
    need = poa_batch_scratch_bytes(b, n, l)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.uint8, device=dev)
    else:
        _check("poa_align_batch scratch", scratch, torch.uint8, 1, dev)
        if scratch.numel() < need:
            raise ValueError(f"poa_align_batch: scratch has "
                             f"{scratch.numel()} bytes, needs {need}")
    packed = torch.empty((b, n + l), dtype=torch.int32, device=dev)
    length = torch.empty((b,), dtype=torch.int32, device=dev)
    aligned = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return packed, length, aligned
    fn = _ext.load("poa_align_batch").poa_align_batch_launch
    _raise_on(fn(letters.data_ptr(), preds.data_ptr(),
                 int(preds.dtype == torch.int16), pmax, n_nodes.data_ptr(),
                 seq.data_ptr(), seq_len.data_ptr(), b, n, l, match,
                 mismatch, go, ge, 2 if l <= POA_SMALL_L else 4,
                 scratch.data_ptr(), packed.data_ptr(), length.data_ptr(),
                 aligned.data_ptr(), _stream(dev)), "poa_align_batch")
    poa_align_batch.launches += 1
    return packed, length, aligned


poa_align_batch.launches = 0

# --------------------------------------------------------------------------
# the pack engine's read step after poa_align: threading and re-rank
# --------------------------------------------------------------------------

POA_GA = 8              # aligned-group member cap (distinct letters)
POA_BIG = 2 ** 30
# key stride of the incremental re-rank.  run_idx is clipped to HALF-1 =
# SK-2, so for the W=4096 config the last two nodes of a maximal-length run
# share a key; the stable sort then orders them by node id, which equals
# path order for nodes created left-to-right in one read, so the collision
# resolves to the correct order by construction.
POA_SK = 4096
POA_HALF = POA_SK - 1
POA_MAX_N = 16384       # graph nodes a lane the step kernels take
# the rank-space inputs of poa_align that poa_rerank writes for the next step
POA_RANK_FIELDS = ("pred_rows", "npred_r", "letters_r")
# node-space state fields [B, N + 1] (one spare slot) of 2, 3 dims
_NODE_FIELDS = ("letters", "npred", "grp_leader", "member_idx", "grp_size",
                "grp_pos", "perm", "keys")
_LANE_FIELDS = ("n_reads", "n_nodes", "n_groups", "fallback")


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather over axis 1 with arbitrary trailing idx dims."""
    b = arr.shape[0]
    return torch.gather(arr, 1, idx.reshape(b, -1).long()).reshape(idx.shape)


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, M, K], idx [B, L] -> [B, L, K]."""
    return torch.gather(
        arr, 1, idx.long()[:, :, None].expand(-1, -1, arr.shape[2]))


def poa_rank_space(st: dict):
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


def _check_step_state(name: str, st: dict, rank_space: bool) -> Tuple[int,
                                                                       int]:
    """The pack engine's state as the step kernels take it (see
    ``poa_thread``); returns (B, N)."""
    dev = st["letters"].device
    b, n1 = st["letters"].shape
    n = n1 - 1
    if n < 1 or n > POA_MAX_N:
        raise ValueError(f"{name}: N must be in [1, {POA_MAX_N}], got {n}")
    for f in _NODE_FIELDS:
        _check(f"{name} {f}", st[f], torch.int32, 2, dev, n1)
    _check(f"{name} preds", st["preds"], torch.int32, 3, dev, POA_PMAX)
    _check(f"{name} members", st["members"], torch.int32, 3, dev, POA_GA)
    _check(f"{name} node_rank", st["node_rank"], torch.int32, 2, dev, n)
    for f in _LANE_FIELDS:
        _check(f"{name} {f}", st[f], torch.int32, 1, dev, b)
    _check(f"{name} path", st["path"], torch.int32, 2, dev)
    shapes = [st[f].shape[0] for f in _NODE_FIELDS + ("preds", "members",
                                                      "node_rank", "path")]
    if set(shapes) != {b} or st["preds"].shape[1] != n1 \
            or st["members"].shape[1] != n1:
        raise ValueError(f"{name}: state fields must share [B, N + 1]")
    if rank_space:
        _check(f"{name} pred_rows", st["pred_rows"], torch.int32, 3, dev,
               POA_PMAX)
        for f in POA_RANK_FIELDS[1:]:
            _check(f"{name} {f}", st[f], torch.int32, 2, dev, n)
        if tuple(st["pred_rows"].shape[:2]) != (b, n) \
                or {st[f].shape[0] for f in POA_RANK_FIELDS[1:]} != {b}:
            raise ValueError(f"{name}: rank-space buffers must be [B, N]")
    return b, n


def poa_thread_plain(st: dict, t: int, w: int, packed: torch.Tensor,
                     tlen: torch.Tensor, best: torch.Tensor) -> None:
    """Plain version: the eager chain of the pack engine's step from the
    alignment's moves to the keys of the re-rank, then the lane counters.
    Masked scatter writes land in the spare slot."""
    seqs, lens = st["seqs"], st["lens"]
    letters, npred, preds = st["letters"], st["npred"], st["preds"]
    n_nodes = st["n_nodes"]
    grp_leader, member_idx = st["grp_leader"], st["member_idx"]
    grp_size, members, grp_pos = st["grp_size"], st["members"], st["grp_pos"]
    n_groups, perm = st["n_groups"], st["perm"]
    path, fallback, keys = st["path"], st["fallback"], st["keys"]

    i32 = torch.int32
    dev = letters.device
    b, n = st["node_rank"].shape
    iota_n = torch.arange(n, dtype=i32, device=dev)[None, :]
    iota_w = torch.arange(w, dtype=i32, device=dev)[None, :]
    ones_w = torch.ones((b, w), dtype=i32, device=dev)

    active = (t < st["n_reads"]) & (fallback == 0)
    seq = seqs[:, t, :w].to(i32)                      # [B, W] char at p
    slen = lens[:, t]
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
    iota_g = torch.arange(POA_GA, dtype=i32, device=dev)[None, None, :]
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
    members_flat.scatter_(1, p_or_n * POA_GA, target)
    j_or_n = torch.where(wmask & joiner, leader, n).long()
    grp_overflow = (wmask & joiner & (gsz >= POA_GA)).any(dim=1)
    members_flat.scatter_(1, j_or_n * POA_GA + gsz.clamp(0, POA_GA - 1).long(),
                          torch.where(gsz < POA_GA, target, -1))
    grp_size.scatter_add_(1, j_or_n, ones_w)

    prevt = torch.nn.functional.pad(target[:, :-1], (1, 0), value=-1)
    em = wmask & (iota_w >= 1) & (prevt >= 0) & (prevt != target)
    tgt_c = target.clamp(0, n - 1)
    tpred = _take_rows(preds, tgt_c)
    npr_t = _take(npred, tgt_c)
    iota_p = torch.arange(POA_PMAX, dtype=i32, device=dev)[None, None, :]
    exists = ((tpred == prevt[:, :, None])
              & (iota_p < npr_t[:, :, None])).any(dim=2)
    add = em & ~exists
    pred_overflow = (add & (npr_t >= POA_PMAX)).any(dim=1)
    a_or_n = torch.where(add, target, n).long()
    preds.view(b, -1).scatter_(
        1, a_or_n * POA_PMAX + npr_t.clamp(0, POA_PMAX - 1).long(),
        torch.where(npr_t < POA_PMAX, prevt, -1))
    npred.scatter_add_(1, a_or_n, ones_w)

    tot = path.shape[1] - 1
    pidx = torch.where(wmask, st["offsets"][:, t, None] + iota_w, tot)
    path.scatter_(1, pidx.long(), target)

    # ---- keys of the incremental re-rank ----
    lead_all = torch.where(purenew, target, leader)
    lead_all = torch.where(isnew, lead_all,
                           _take(grp_leader, matched.clamp(0, n - 1)))
    placed = wmask & ~purenew
    gpos_t = _take(grp_pos, lead_all.clamp(0, n - 1))
    gmark = torch.where(placed, gpos_t, POA_BIG)
    gnext = torch.flip(torch.cummin(torch.flip(gmark, [1]), dim=1).values,
                       [1])
    gnextf = torch.where(gnext >= POA_BIG, n_groups[:, None], gnext)
    lastp = torch.cummax(torch.where(placed, iota_w, -1), dim=1).values
    run_idx = iota_w - lastp - 1
    key_new = gnextf * POA_SK + run_idx.clamp(0, POA_HALF - 1)

    is_leader = grp_leader[:, :n] == iota_n
    keys[:, n] = POA_BIG
    keys[:, :n] = torch.where(is_leader & (iota_n < n_nodes[:, None]),
                              grp_pos[:, :n] * POA_SK + POA_HALF, POA_BIG)
    keys.scatter_(1, p_or_n, key_new.to(i32))

    # ---- lane counters ----
    n_groups.copy_(torch.where(
        ok, n_groups + (purenew & wmask).sum(dim=1).to(i32), n_groups))
    fallback.copy_(fallback | torch.where(
        active,
        overflow_nodes.to(i32) + (pred_overflow.to(i32) << 1)
        + (grp_overflow.to(i32) << 2), 0))
    n_nodes.copy_(torch.where(ok, n_nodes + n_new, n_nodes))


def poa_thread(st: dict, t: int, w: int, packed: torch.Tensor,
               tlen: torch.Tensor, best: torch.Tensor) -> None:
    """Thread read ``t`` of every lane into its graph, in place, from
    ``poa_align``'s outputs (packed [B, w], tlen, best [B]) at the step's
    width ``w``: decode the moves to nodes, join aligned groups, add nodes,
    edges, group members and the path, write the re-rank's keys (node id
    order, valid below the new n_nodes) and the lane counters (n_nodes,
    n_groups, fallback).  Every gather sees the state as it was before the
    step's scatters.

    ``st``, int32 unless noted, every array contiguous: seqs [B, R, W']
    uint8 (w <= W'), lens, offsets [B, R]; n_reads, n_nodes, n_groups,
    fallback [B]; letters, npred, grp_leader, member_idx, grp_size, grp_pos,
    perm, keys [B, N + 1] (slot N spare), preds [B, N + 1, 16], members
    [B, N + 1, 8], node_rank [B, N], path [B, T + 1].  N <= POA_MAX_N.  A
    lane is active while t < n_reads and fallback == 0; a lane whose new
    nodes would pass N threads nothing and falls back (bit 1), as does one
    whose edge or group insert passes its cap (bits 2, 4, state kept as the
    plain version leaves it)."""
    b, n = _check_step_state("poa_thread", st, rank_space=False)
    dev = st["letters"].device
    seqs = st["seqs"]
    _check("poa_thread seqs", seqs, torch.uint8, 3, dev)
    r = seqs.shape[1]
    for f in ("lens", "offsets"):
        _check(f"poa_thread {f}", st[f], torch.int32, 2, dev, r)
    _check("poa_thread packed", packed, torch.int32, 2, dev, w)
    for name, v in (("tlen", tlen), ("best", best)):
        _check(f"poa_thread {name}", v, torch.int32, 1, dev, b)
    if not (0 <= t < r and 1 <= w <= min(seqs.shape[2], POA_MAX_W)
            and seqs.shape[0] == b and packed.shape[0] == b):
        raise ValueError(f"poa_thread: step {t} of {r} at width {w} (reads "
                         f"{tuple(seqs.shape)}, packed {tuple(packed.shape)})")
    if not _on_card(packed):
        return poa_thread_plain(st, t, w, packed, tlen, best)
    if b == 0:
        return None
    fn = _ext.load("poa_thread").poa_thread_launch
    ptr = [st[f].data_ptr() for f in (
        "seqs", "lens", "offsets", "n_reads", "letters", "npred", "preds",
        "grp_leader", "member_idx", "grp_size", "members", "grp_pos", "perm",
        "path", "keys", "n_nodes", "n_groups", "fallback")]
    _raise_on(fn(*ptr, packed.data_ptr(), tlen.data_ptr(), best.data_ptr(),
                 b, r, seqs.shape[2], n, st["path"].shape[1] - 1, t, w,
                 _stream(dev)), "poa_thread")
    poa_thread.launches += 1
    return None


poa_thread.launches = 0


def poa_rerank_plain(st: dict) -> None:
    """Plain version: the eager re-rank of the pack engine's step (one
    stable sort of the keys), then ``poa_rank_space`` written for the ranks
    below n_nodes."""
    keys, grp_size, grp_pos = st["keys"], st["grp_size"], st["grp_pos"]
    grp_leader, member_idx = st["grp_leader"], st["member_idx"]
    node_rank, perm = st["node_rank"], st["perm"]
    n_nodes, n_groups = st["n_nodes"], st["n_groups"]
    i32 = torch.int32
    b, n = node_rank.shape
    iota_n = torch.arange(n, dtype=i32, device=keys.device)[None, :]

    # stable: equal keys (see POA_SK) must keep node-id order
    order = torch.sort(keys[:, :n], dim=1, stable=True).indices
    gsz_s = torch.gather(grp_size, 1, order)
    live_pos = iota_n < n_groups[:, None]
    iota_bn = iota_n.expand(b, n).contiguous()
    grp_pos.scatter_(1, torch.where(live_pos, order, n), iota_bn)
    sz_sorted = torch.where(live_pos, gsz_s, 0)
    starts = torch.cumsum(sz_sorted, dim=1, dtype=i32) - sz_sorted
    posn = _take(grp_pos, grp_leader[:, :n].clamp(0, n - 1))
    rank_new = _take(starts, posn.clamp(0, n - 1)) + member_idx[:, :n]
    live = iota_n < n_nodes[:, None]
    node_rank.copy_(torch.where(live, rank_new, n))
    perm.scatter_(1, node_rank.long(), iota_bn)
    # the next step's inputs of poa_align, ranks below n_nodes
    for name, new in zip(POA_RANK_FIELDS, poa_rank_space(st)):
        buf = st[name]
        keep = live if buf.dim() == 2 else live[:, :, None]
        buf.copy_(torch.where(keep, new, buf))


def poa_rerank(st: dict) -> None:
    """The incremental re-rank of every lane after ``poa_thread``, in place:
    the stable order of the keys below n_nodes gives each live group its
    position (grp_pos) and each node below n_nodes its rank (node_rank, N
    above), perm inverts node_rank, and pred_rows / npred_r / letters_r
    [B, N(, 16)] (``poa_rank_space``) are written for the ranks below
    n_nodes, the rows poa_align reads.  ``st`` as ``poa_thread`` takes it,
    plus those three buffers.

    On the card the kernel orders a lane's leaders by counting when its
    keys have the structure poa_thread gives them, and sorts them
    otherwise; ``poa_rerank.sort_lanes[device]`` (an int32 [1] tensor on
    that card, made at the first launch there) counts the lanes sorted.
    Nothing on the engine's path reads it."""
    b, n = _check_step_state("poa_rerank", st, rank_space=True)
    dev = st["letters"].device
    if not _on_card(st["keys"]):
        return poa_rerank_plain(st)
    if b == 0:
        return None
    fn = _ext.load("poa_rerank").poa_rerank_launch
    counter = poa_rerank.sort_lanes.get(dev)
    if counter is None:
        counter = poa_rerank.sort_lanes[dev] = torch.zeros(
            1, dtype=torch.int32, device=dev)
    ptr = [st[f].data_ptr() for f in (
        "keys", "grp_size", "grp_leader", "member_idx", "preds", "npred",
        "letters", "n_nodes", "n_groups", "grp_pos", "perm", "node_rank",
        *POA_RANK_FIELDS)]
    _raise_on(fn(*ptr, counter.data_ptr(), b, n, _stream(dev)),
              "poa_rerank")
    poa_rerank.launches += 1
    return None


poa_rerank.launches = 0
poa_rerank.sort_lanes = {}

# --------------------------------------------------------------------------
# cluster's score path: join, decision, block replay
# --------------------------------------------------------------------------

# the block replay keeps a block's owners in one CTA's shared memory
GREEDY_MAX_K = 4096


def _check_table(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device) -> None:
    """A 2-d table read row by row in place: any row stride, unit column
    stride (a class slice ``hs[:, :width]`` of the sketch passes)."""
    if t.dtype != dtype or t.dim() != 2 or t.device != device:
        raise ValueError(f"{name}: expected 2-d {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if t.shape[1] < 1 or (t.shape[0] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: expected width >= 1 and unit column "
                         f"stride, got {tuple(t.shape)} strides {t.stride()}")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def join_expand_plain(rows, cols, row_ids, col_ids, row_tab, col_tab,
                      hs_a, ps_a, hs_b, ps_b, nk, m_cap: int,
                      total: Optional[torch.Tensor] = None,
                      bound: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Plain version: the rows of both tables gathered into [B, W] copies,
    then ops/join_device.join_expand (the eager chain the score path ran
    before the kernel).  ``total`` and ``bound`` as in ``join_expand``."""
    a_ids = row_ids[rows]
    b_ids = col_ids[cols]
    a_t = a_ids if row_tab is row_ids else row_tab[rows]
    b_t = b_ids if col_tab is col_ids else col_tab[cols]
    p1, p2, tot = join_device.join_expand(hs_a[a_t], ps_a[a_t], nk[a_ids],
                                          hs_b[b_t], ps_b[b_t], nk[b_ids],
                                          m_cap)
    n_valid = torch.clamp(tot, max=m_cap)
    valid = torch.arange(m_cap, device=p1.device)[None, :] < n_valid[:, None]
    if total is None:
        total = tot
    else:
        total.copy_(tot)
    if bound is None:
        bound = torch.zeros(1, dtype=torch.int32, device=p1.device)
    if rows.shape[0]:
        torch.maximum(bound, n_valid.max().reshape(1), out=bound)
    return p1, p2, total, valid, bound


def join_expand(rows: torch.Tensor, cols: torch.Tensor,
                row_ids: torch.Tensor, col_ids: torch.Tensor,
                row_tab: torch.Tensor, col_tab: torch.Tensor,
                hs_a: torch.Tensor, ps_a: torch.Tensor, hs_b: torch.Tensor,
                ps_b: torch.Tensor, nk: torch.Tensor, m_cap: int,
                total: Optional[torch.Tensor] = None,
                bound: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The common-k-mer join of B read pairs (any B below 2^31: a whole
    (class, tier) range of a wave in one launch), each read from its two
    table rows in place.  Pair i joins a = row_ids[rows[i]] (row
    row_tab[rows[i]] of hs_a/ps_a) with b = col_ids[cols[i]] (row
    col_tab[cols[i]] of hs_b/ps_b), over their first nk[a] / nk[b] entries.

    rows, cols [B] and row_ids/row_tab, col_ids/col_tab int64; hs_* [*, W*]
    int64 hashes < 2^32 sorted by (hash, pos) over each read's first nk
    entries, ps_* the co-sorted int32 positions (>= 0), each table with unit
    column stride (class slices of the sketch are read in place); nk int32
    by global read id; 1 <= m_cap <= LIS_MAX_M.

    Returns (p1, p2 [B, m_cap] int32: the first m_cap matches in (p1, p2)
    order, p1 padded with 0 and p2 with INT32_MAX; total [B] int32, the true
    match count; valid [B, m_cap] bool, the first min(total, m_cap) slots;
    bound [1] int32).  On overflow (total > m_cap) only total is
    contractual.  ``total``: an optional int32 [B] tensor written in place
    (a slice of the caller's output); ``bound``: an optional int32 [1] tensor
    raised in place to the batch's largest min(total, m_cap), read by
    lis_filter on the device (a fresh zero when omitted)."""
    dev = rows.device
    _check("join_expand rows", rows, torch.int64, 1, dev)
    _check("join_expand cols", cols, torch.int64, 1, dev, rows.shape[0])
    for name, t in (("row_ids", row_ids), ("col_ids", col_ids),
                    ("row_tab", row_tab), ("col_tab", col_tab)):
        _check(f"join_expand {name}", t, torch.int64, 1, dev)
    if row_tab.shape != row_ids.shape or col_tab.shape != col_ids.shape:
        raise ValueError("join_expand: row_tab / col_tab must match row_ids "
                         "/ col_ids")
    _check_table("join_expand hs_a", hs_a, torch.int64, dev)
    _check_table("join_expand ps_a", ps_a, torch.int32, dev)
    _check_table("join_expand hs_b", hs_b, torch.int64, dev)
    _check_table("join_expand ps_b", ps_b, torch.int32, dev)
    if hs_a.shape != ps_a.shape or hs_b.shape != ps_b.shape:
        raise ValueError("join_expand: hashes and positions must share a "
                         "shape on each side")
    _check("join_expand nk", nk, torch.int32, 1, dev)
    if not 1 <= m_cap <= LIS_MAX_M:
        raise ValueError(f"join_expand: m_cap must be in [1, {LIS_MAX_M}], "
                         f"got {m_cap}")
    b = rows.shape[0]
    if b >= 2 ** 31:
        raise ValueError(f"join_expand: {b} pairs, the kernel takes < 2^31")
    if total is not None:
        _check("join_expand total", total, torch.int32, 1, dev, b)
    if bound is not None:
        _check("join_expand bound", bound, torch.int32, 1, dev, 1)
    if not _on_card(rows):
        return join_expand_plain(rows, cols, row_ids, col_ids, row_tab,
                                 col_tab, hs_a, ps_a, hs_b, ps_b, nk, m_cap,
                                 total, bound)
    if total is None:
        total = torch.empty((b,), dtype=torch.int32, device=dev)
    if bound is None:
        bound = torch.zeros((1,), dtype=torch.int32, device=dev)
    p1 = torch.empty((b, m_cap), dtype=torch.int32, device=dev)
    p2 = torch.empty_like(p1)
    valid = torch.empty((b, m_cap), dtype=torch.bool, device=dev)
    if b == 0:
        return p1, p2, total, valid, bound
    fn = _ext.load("join_expand").join_expand_launch
    _raise_on(fn(rows.data_ptr(), cols.data_ptr(), row_ids.data_ptr(),
                 col_ids.data_ptr(), row_tab.data_ptr(), col_tab.data_ptr(),
                 hs_a.data_ptr(), ps_a.data_ptr(), _row_stride(hs_a),
                 _row_stride(ps_a), hs_a.shape[1], hs_b.data_ptr(),
                 ps_b.data_ptr(), _row_stride(hs_b), _row_stride(ps_b),
                 hs_b.shape[1], nk.data_ptr(), b, m_cap, p1.data_ptr(),
                 p2.data_ptr(), valid.data_ptr(), total.data_ptr(),
                 bound.data_ptr(), _stream(dev)), "join_expand")
    join_expand.launches += 1
    return p1, p2, total, valid, bound


join_expand.launches = 0


def score_pair_bytes(join, rows: torch.Tensor, wa: int, wb: int,
                     m_cap: int) -> int:
    """The bytes a pair holds in one score-path launch (``join``, then
    lis_filter and score_decide over B pairs) at these table widths and
    m_cap, for sizing launches.  On the card: the [B, m_cap] match lists
    (p1, p2 int32 and valid, 9 bytes a slot) and the launch's [B] outputs
    and slices (total, border, lis_filter's four, the pair indices).  The
    plain versions (``join`` is join_expand_plain, or ``rows`` lie on the
    CPU) also gather both table rows into [B, W] int64 / int32 copies and
    run the join's [B, W] int64 searches and prefix sums (~64 bytes an
    entry of the two rows in all), and the plain join's and LIS scans'
    [B, m_cap] temporaries (~160 bytes a slot)."""
    if join is join_expand_plain or not _on_card(rows):
        return 64 * (wa + wb) + 160 * m_cap + 48
    return 9 * m_cap + 48


def join_expand_config(wa: int, wb: int, m_cap: int) -> dict:
    """On the card: the launch shape the join kernel takes at these widths
    and m_cap (threads a pair, pairs a CTA, rows staged in shared memory or
    not, dynamic shared memory a CTA, CTAs resident an SM)."""
    fn = _ext.load("join_expand").join_expand_config
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    _raise_on(fn(wa, wb, m_cap, ctypes.cast(out, ctypes.c_void_p)),
              "join_expand_config")
    return dict(threads_a_pair=out[0], pairs_a_cta=out[1],
                staged=bool(out[2]), smem_bytes=out[3], ctas_an_sm=out[4])


def score_decide_plain(rows, cols, row_ids, col_ids, bases, var, total, lens,
                       sc_tab, t_v, var_band, strand_val: int, w, cache,
                       cache_n: int, m_cap: int,
                       border: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the eager decision the score path ran before the
    kernel.  Same arguments and effects as ``score_decide``."""
    a_ids = row_ids[rows]
    b_ids = col_ids[cols]
    mn = torch.minimum(lens[a_ids], lens[b_ids])
    score_ok = bases >= sc_tab[mn]
    borderline = torch.abs(var - t_v) <= var_band
    fits = total <= m_cap
    win = score_ok & (var < t_v) & ~borderline & fits
    bord = score_ok & borderline & fits
    decided = fits & ~bord
    cur = w[rows, cols]
    w[rows, cols] = torch.where(win, torch.clamp(cur, min=strand_val), cur)
    if cache is not None:
        flat = a_ids * cache_n + b_ids
        cache[flat] = torch.where(decided, torch.where(win, 2, 1),
                                  cache[flat]).to(torch.uint8)
    if border is None:
        return bord
    border.copy_(bord)
    return border


def score_decide(rows: torch.Tensor, cols: torch.Tensor,
                 row_ids: torch.Tensor, col_ids: torch.Tensor,
                 bases: torch.Tensor, var: torch.Tensor, total: torch.Tensor,
                 lens: torch.Tensor, sc_tab: torch.Tensor, t_v: torch.Tensor,
                 var_band: torch.Tensor, strand_val: int, w: torch.Tensor,
                 cache: Optional[torch.Tensor], cache_n: int, m_cap: int,
                 border: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decision of B scored pairs (cluster.cpp:24-37): score_ok = bases
    >= sc_tab[min(lens[a], lens[b])], borderline = |var - t_v| <= var_band
    (float32), fits = total <= m_cap; a win (score_ok, var < t_v, not
    borderline, fits) sets w[row, col] = max(w[row, col], strand_val), and a
    decided pair (fits, not border) sets cache[a * cache_n + b] to 2 (win) or
    1, both in place.  Returns border = score_ok & borderline & fits, the
    pairs the host rescores (written into ``border`` when given).

    rows, cols [B] int64 into row_ids / col_ids (int64 global ids); bases,
    total [B] int32, var [B] float32; lens, sc_tab int32; t_v, var_band
    float32 scalar tensors; w [R, C] int8; cache uint8 [cache_n^2] or None.
    The (row, col) pairs, and the (a, b) pairs, of one call are unique.  One
    launch takes any B below 2^31, a thread a pair."""
    dev = rows.device
    b = rows.shape[0]
    if b >= 2 ** 31:
        raise ValueError(f"score_decide: {b} pairs, the kernel takes < 2^31")
    _check("score_decide rows", rows, torch.int64, 1, dev)
    _check("score_decide cols", cols, torch.int64, 1, dev, b)
    _check("score_decide row_ids", row_ids, torch.int64, 1, dev)
    _check("score_decide col_ids", col_ids, torch.int64, 1, dev)
    _check("score_decide bases", bases, torch.int32, 1, dev, b)
    _check("score_decide var", var, torch.float32, 1, dev, b)
    _check("score_decide total", total, torch.int32, 1, dev, b)
    _check("score_decide lens", lens, torch.int32, 1, dev)
    _check("score_decide sc_tab", sc_tab, torch.int32, 1, dev)
    for name, t in (("t_v", t_v), ("var_band", var_band)):
        _check(f"score_decide {name}", t.reshape(-1), torch.float32, 1, dev,
               1)
    _check("score_decide w", w, torch.int8, 2, dev)
    if cache is not None:
        _check("score_decide cache", cache, torch.uint8, 1, dev)
        if cache.shape[0] < cache_n * cache_n:
            raise ValueError(f"score_decide: cache has {cache.shape[0]} "
                             f"entries, needs {cache_n * cache_n}")
    if border is not None:
        _check("score_decide border", border, torch.bool, 1, dev, b)
    if not _on_card(rows):
        return score_decide_plain(rows, cols, row_ids, col_ids, bases, var,
                                  total, lens, sc_tab, t_v, var_band,
                                  strand_val, w, cache, cache_n, m_cap,
                                  border)
    if border is None:
        border = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return border
    fn = _ext.load("score_decide").score_decide_launch
    _raise_on(fn(rows.data_ptr(), cols.data_ptr(), row_ids.data_ptr(),
                 col_ids.data_ptr(), bases.data_ptr(), var.data_ptr(),
                 total.data_ptr(), lens.data_ptr(), sc_tab.data_ptr(),
                 t_v.data_ptr(), var_band.data_ptr(), strand_val,
                 w.data_ptr(), w.shape[1],
                 None if cache is None else cache.data_ptr(), cache_n, b,
                 m_cap, border.data_ptr(), _stream(dev)), "score_decide")
    score_decide.launches += 1
    return border


score_decide.launches = 0


def greedy_owner_plain(w: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain version: one step of a few small launches for each row that
    wins a later read (a row without wins claims nothing, seed or not),
    the rows found with one host sync."""
    n = w.shape[0]
    dev = w.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    live = (iota[None, :] > iota[:, None]) & (iota[None, :] < n_valid)
    wins = (w > 0) & live
    rev_w = w == 1
    owner = iota.clone()
    rev = torch.zeros(n, dtype=torch.bool, device=dev)
    unclaimed = torch.ones(n, dtype=torch.bool, device=dev)
    steps = torch.nonzero(wins[:n_valid].any(dim=1)).flatten().tolist()
    for i in steps:
        newly = wins[i] & unclaimed & unclaimed[i]
        owner = torch.where(newly, i, owner)
        rev = torch.where(newly, rev_w[i], rev)
        unclaimed = unclaimed & ~newly
    return (owner << 1) | rev.to(torch.int32)


def greedy_owner(w: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Exact replay of the reference's greedy absorption (cluster.cpp:124-
    166) inside one block.  ``w`` [K, K] int8, K <= GREEDY_MAX_K: 0 no, 1
    reverse win, 2 forward win (row = the earlier read).  Rows are walked
    in order; a row whose read still owns itself claims every later
    unclaimed column below ``n_valid`` it wins.  Returns packed [K] int32 =
    (owner << 1) | rev.  One launch, no host sync."""
    dev = w.device
    _check("greedy_owner w", w, torch.int8, 2, dev)
    k = w.shape[0]
    if w.shape[1] != k or k > GREEDY_MAX_K:
        raise ValueError(f"greedy_owner: w must be [K, K] with K <= "
                         f"{GREEDY_MAX_K}, got {tuple(w.shape)}")
    if not 0 <= n_valid <= k:
        raise ValueError(f"greedy_owner: n_valid {n_valid} not in [0, {k}]")
    if not _on_card(w):
        return greedy_owner_plain(w, n_valid)
    packed = torch.empty((k,), dtype=torch.int32, device=dev)
    if k == 0:
        return packed
    fn = _ext.load("greedy_owner").greedy_owner_launch
    _raise_on(fn(w.data_ptr(), k, n_valid, packed.data_ptr(), _stream(dev)),
              "greedy_owner")
    greedy_owner.launches += 1
    return packed


greedy_owner.launches = 0


# --------------------------------------------------------------------------
# cluster's decision wave: the gate, and the sweep replay
# --------------------------------------------------------------------------

# K classes the gate routes to (csrc/gate_block.cu counts a class's fresh
# pairs of a (row, 128-column tile) in eight bits, four classes a word)
GATE_MAX_CLASSES = 4
# the gate's output tile (csrc/bv_tile.cuh kBM x kBN) and its 128 words
GATE_TILE = 128
# pass-1 CTAs resident on an SM (__launch_bounds__(256, 2); ~77 KB of shared
# memory a CTA)
GATE_CTAS_PER_SM = 2
# what pass 1 stages (csrc/gate_block.cu): the row and column tiles' orders
# (kMaxSideTiles), the tiles a CTA lists (kMaxWalk)
GATE_MAX_SIDE_TILES = 1024
GATE_MAX_WALK = 256


def gate_block_plan(a: int, c: int, n_sm: int) -> dict:
    """Pass 1's launch plan for A rows x C columns on ``n_sm`` SMs: the
    ceil(A / 128) x ceil(C / 128) output tiles (``tiles_r``, ``tiles_c``;
    tile t is row tile t % tiles_r, column tile t / tiles_r) and ``ctas``
    CTAs, as many as fit on the card at once (``n_sm`` x GATE_CTAS_PER_SM)
    but no more than the tiles.  The tiles are dealt out in index order,
    the k-th to CTA k % ctas; on the card the tiles whose rows' orders all
    reach their columns' (no pair there can pass; the lower triangle of a
    block wave) are skipped first.  ``gate_block_walk`` lists what each CTA
    takes.  ``supported``: the kernel takes the plan (at most
    GATE_MAX_SIDE_TILES row and column tiles, GATE_MAX_WALK tiles a CTA);
    the wrapper raises otherwise."""
    tiles_r, tiles_c = -(-a // GATE_TILE), -(-c // GATE_TILE)
    tiles = tiles_r * tiles_c
    ctas = min(tiles, n_sm * GATE_CTAS_PER_SM)
    per = -(-tiles // ctas) if ctas else 0
    return dict(ctas=ctas, tiles_r=tiles_r, tiles_c=tiles_c, tiles=tiles,
                tiles_per_cta=per,
                supported=tiles_r + tiles_c <= GATE_MAX_SIDE_TILES
                and per <= GATE_MAX_WALK)


def gate_block_walk(plan: dict, row_min=None, col_max=None) -> list:
    """The tiles each CTA of ``plan`` computes, in its order: for CTA i,
    [(tile row, tile column), ...].  Given the tiles' orders (each row
    tile's least row order, each column tile's largest column order, as
    csrc/gate_block.cu's side kernel writes them), the tiles that may pass
    (row_min < col_max) in index order, the k-th dealt to CTA k % ctas,
    the others skipped, as pass 1 deals them on the card; else every tile
    (a sweep's orders skip none)."""
    ctas, tiles_r = plan["ctas"], plan["tiles_r"]
    left = [t for t in range(plan["tiles"]) if row_min is None
            or row_min[t % tiles_r] < col_max[t // tiles_r]]
    return [[(t % tiles_r, t // tiles_r) for t in left[cta::ctas]]
            for cta in range(ctas)]


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# a pinned host buffer a device, into which the gate's class counts are
# copied: its one host read
_gate_host = {}


def gate_block_pass1(bvp_rows, bvc_rows, order_rows, group_rows, bvp_cols,
                     bvc_cols, order_cols, group_cols, tab, cache, cache_n,
                     row_ids, col_ids, w, strand_val, nk, bounds) -> dict:
    """gate_block's pass 1 on the card, its inputs already checked (A, C >
    0): the gate, the cache fold into w, the mask of fresh pairs, their
    counts by (class, row) and, by the last CTA, the offsets and the class
    counts.  Returns the state that ``gate_block_read`` and
    ``gate_block_pass2`` take."""
    dev = w.device
    a, c = bvp_rows.shape[0], bvp_cols.shape[0]
    n_cls = bounds.shape[0] + 1
    plan = gate_block_plan(a, c, _sm_count(dev))
    if not plan["supported"]:
        raise ValueError(
            f"gate_block: {a} x {c} is {plan['tiles_r']} x {plan['tiles_c']} "
            f"tiles, {plan['tiles_per_cta']} a CTA; the kernel takes at "
            f"most {GATE_MAX_SIDE_TILES} row and column tiles and "
            f"{GATE_MAX_WALK} a CTA")
    n_words = -(-c // 32)
    mask = torch.empty((a, n_words), dtype=torch.int32, device=dev)
    # counts, the ticket, offsets, the columns' two class planes, the row
    # tiles' least and the column tiles' largest orders
    scratch = torch.empty(2 * n_cls * a + 1 + 2 * n_words + plan["tiles_r"]
                          + plan["tiles_c"], dtype=torch.int32, device=dev)
    class_counts = torch.empty(n_cls, dtype=torch.int32, device=dev)
    stream = _stream(dev)
    _raise_on(_ext.load("gate_block").gate_tile_launch(
        bvp_rows.data_ptr(), bvp_cols.data_ptr(), a, c, bvc_rows.data_ptr(),
        bvc_cols.data_ptr(), order_rows.data_ptr(), order_cols.data_ptr(),
        group_rows.data_ptr(), group_cols.data_ptr(), row_ids.data_ptr(),
        col_ids.data_ptr(), nk.data_ptr(), tab.data_ptr(),
        None if cache is None else cache.data_ptr(), cache_n, w.data_ptr(),
        strand_val, bounds.data_ptr(), n_cls - 1, mask.data_ptr(),
        scratch.data_ptr(), class_counts.data_ptr(), plan["ctas"], stream),
        "gate_block")
    gate_block.launches += 1
    return dict(stream=stream, a=a, c=c, n_cls=n_cls, mask=mask,
                scratch=scratch, class_counts=class_counts, row_ids=row_ids,
                nk=nk, bounds=bounds)


def gate_block_read(st: dict) -> Tuple[int, ...]:
    """The gate's one host read: the class counts, by one copy into a
    pinned buffer right after pass 1, then a wait for the stream."""
    dev = st["class_counts"].device
    host = _gate_host.get(dev)
    if host is None:
        host = _gate_host[dev] = torch.empty(
            GATE_MAX_CLASSES, dtype=torch.int32, pin_memory=True)
    n = st["n_cls"]
    host[:n].copy_(st["class_counts"], non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return tuple(host[:n].tolist())


def gate_block_pass2(st: dict, n_class: Tuple[int, ...]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gate_block's pass 2: the fresh pairs, sum(n_class) of them, in the
    plain version's order."""
    dev = st["class_counts"].device
    total = sum(n_class)
    rows = torch.empty(total, dtype=torch.int64, device=dev)
    cols = torch.empty(total, dtype=torch.int64, device=dev)
    if total:
        _raise_on(_ext.load("gate_block").gate_emit_launch(
            st["mask"].data_ptr(), st["a"], st["c"], st["scratch"].data_ptr(),
            st["row_ids"].data_ptr(), st["nk"].data_ptr(),
            st["bounds"].data_ptr(), st["n_cls"] - 1, rows.data_ptr(),
            cols.data_ptr(), st["stream"]), "gate_block")
    return rows, cols


def gate_block_plain(bvp_rows, bvc_rows, order_rows, group_rows, bvp_cols,
                     bvc_cols, order_cols, group_cols, tab, cache,
                     cache_n: int, row_ids, col_ids, w, strand_val: int, nk,
                     bounds, common=bv_common_plain):
    """Plain version: the eager chain the wave ran before the kernel, on
    ``common`` (bv_common_plain; bv_common gives that earlier path on the
    card).  Same arguments, outputs and effect on ``w`` as ``gate_block``."""
    cmn = common(bvp_rows, bvp_cols)
    mmax = torch.maximum(bvc_rows[:, None], bvc_cols[None, :])
    passed = (cmn >= tab[mmax]) \
        & (order_rows[:, None] < order_cols[None, :]) \
        & (group_rows[:, None] == group_cols[None, :])
    rows, cols = torch.nonzero(passed, as_tuple=True)
    ra = row_ids[rows]
    rb = col_ids[cols]
    if cache is not None:
        cval = cache[ra * cache_n + rb]
        # (row, col) pairs are unique, so a masked write is the scatter-max
        cur = w[rows, cols]
        w[rows, cols] = torch.where(cval == 2,
                                    torch.clamp(cur, min=strand_val), cur)
        fresh = cval == 0
        rows, cols, ra, rb = rows[fresh], cols[fresh], ra[fresh], rb[fresh]
    pair_nk = torch.maximum(nk[ra], nk[rb])
    cls = (pair_nk[:, None] > bounds[None, :]).sum(dim=1)
    cls, order = torch.sort(cls, stable=True)
    class_counts = torch.bincount(cls, minlength=bounds.shape[0] + 1).to(
        torch.int32)
    return rows[order], cols[order], class_counts, \
        tuple(class_counts.tolist())


def gate_block(bvp_rows: torch.Tensor, bvc_rows: torch.Tensor,
               order_rows: torch.Tensor, group_rows: torch.Tensor,
               bvp_cols: torch.Tensor, bvc_cols: torch.Tensor,
               order_cols: torch.Tensor, group_cols: torch.Tensor,
               tab: torch.Tensor, cache: Optional[torch.Tensor], cache_n: int,
               row_ids: torch.Tensor, col_ids: torch.Tensor, w: torch.Tensor,
               strand_val: int, nk: torch.Tensor, bounds: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          Tuple[int, ...]]:
    """The bitvector gate of A rows x C columns (cluster.cpp:13-19): a pair
    passes when popcount(bvp_row AND bvp_col) >= tab[max(bvc_row, bvc_col)],
    order_row < order_col and group_row == group_col.  A passing pair whose
    score cache entry cache[row_id * cache_n + col_id] is 2 folds strand_val
    into w (w = max(w, strand_val), in place); one whose entry is 0, or every
    passing pair when ``cache`` is None, is fresh.  A fresh pair's class is
    #(bounds < max(nk[row_id], nk[col_id])).

    bvp_* [*, 128] int32 packed words; bvc_*, order_*, group_* int32 and
    row_ids / col_ids int64 (global read ids) [A] / [C]; tab int32 [4097];
    cache uint8 [cache_n^2] or None; w int8 [A, C]; nk int32 by read id;
    bounds int32 [n_classes - 1], n_classes <= GATE_MAX_CLASSES.

    Returns (rows, cols [total] int64, class_counts [n_classes] int32), on
    the device: the fresh pairs stably sorted by class, row-major within a
    class; and the same class counts as the host read them (a tuple), the
    one read the gate makes.  On the card: pass 1 (``gate_block_pass1``,
    persistent, its plan from ``gate_block_plan``), the read right after it
    (``gate_block_read``: it sizes rows and cols), pass 2
    (``gate_block_pass2``); nothing runs between them, and no [A, C]
    intermediate."""
    dev = w.device
    a, c = bvp_rows.shape[0], bvp_cols.shape[0]
    _check("gate_block bvp_rows", bvp_rows, torch.int32, 2, dev, BV_WORDS)
    _check("gate_block bvp_cols", bvp_cols, torch.int32, 2, dev, BV_WORDS)
    for side, n, vecs in (("rows", a, (bvc_rows, order_rows, group_rows)),
                          ("cols", c, (bvc_cols, order_cols, group_cols))):
        for name, t in zip(("bvc", "order", "group"), vecs):
            _check(f"gate_block {name}_{side}", t, torch.int32, 1, dev, n)
    _check("gate_block row_ids", row_ids, torch.int64, 1, dev, a)
    _check("gate_block col_ids", col_ids, torch.int64, 1, dev, c)
    _check("gate_block tab", tab, torch.int32, 1, dev, BV_BITS + 1)
    _check("gate_block w", w, torch.int8, 2, dev, c)
    if w.shape[0] != a:
        raise ValueError(f"gate_block: w is {tuple(w.shape)}, rows x cols "
                         f"are {a} x {c}")
    if a * c >= 2 ** 31:
        raise ValueError(f"gate_block: {a} x {c} pairs, the pair list's "
                         "int32 offsets take < 2^31")
    _check("gate_block nk", nk, torch.int32, 1, dev)
    _check("gate_block bounds", bounds, torch.int32, 1, dev)
    if bounds.shape[0] >= GATE_MAX_CLASSES:
        raise ValueError(f"gate_block: {bounds.shape[0] + 1} classes, at "
                         f"most {GATE_MAX_CLASSES}")
    if cache is not None:
        _check("gate_block cache", cache, torch.uint8, 1, dev)
        if cache.shape[0] < cache_n * cache_n:
            raise ValueError(f"gate_block: cache has {cache.shape[0]} "
                             f"entries, needs {cache_n * cache_n}")
    if not _on_card(w):
        return gate_block_plain(bvp_rows, bvc_rows, order_rows, group_rows,
                                bvp_cols, bvc_cols, order_cols, group_cols,
                                tab, cache, cache_n, row_ids, col_ids, w,
                                strand_val, nk, bounds)
    if bvp_rows.data_ptr() % 16 or bvp_cols.data_ptr() % 16:
        raise ValueError("gate_block: rows must be 16-byte aligned (cp.async "
                         "of 16-byte units)")
    n_cls = bounds.shape[0] + 1
    if a == 0 or c == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty.clone(), torch.zeros(
            n_cls, dtype=torch.int32, device=dev), (0,) * n_cls
    st = gate_block_pass1(bvp_rows, bvc_rows, order_rows, group_rows,
                          bvp_cols, bvc_cols, order_cols, group_cols, tab,
                          cache, cache_n, row_ids, col_ids, w, strand_val,
                          nk, bounds)
    n_class = gate_block_read(st)
    rows, cols = gate_block_pass2(st, n_class)
    return rows, cols, st["class_counts"], n_class


gate_block.launches = 0

# absorb_rest's panel: 16 bytes a thread, 32 threads (csrc/absorb_rest.cu),
# the least rows a strip (one step of its CTA: 8 warps, 4 rows' loads in
# flight each), the CTAs an SM the plan aims for, the most rows taken by
# the column layout (a lane a column, 32 columns a CTA) instead
ABSORB_PANEL = 512
ABSORB_MIN_ROWS = 32
ABSORB_CTAS_PER_SM = 2
ABSORB_ONE_STRIP = 512
ABSORB_COLUMNS = 32
_ABSORB_LAYOUTS = {"panels": 0, "columns": 1}


def absorb_rest_plan(s: int, c: int, n_sm: int) -> dict:
    """absorb_rest's launch plan for an S x C win matrix on ``n_sm`` SMs.
    Above ABSORB_ONE_STRIP rows, ``layout`` "panels": ``panels`` of 512
    columns x ``strips`` of ``rows_per_strip`` rows, as many strips as make
    ABSORB_CTAS_PER_SM CTAs an SM, but at least ABSORB_MIN_ROWS rows a
    strip.  Up to it, "columns": one CTA a 32 columns, all rows (measured
    faster there, PERF.md §6, PR 14).  ``absorb_rest_cells`` lists the
    CTAs."""
    if s <= ABSORB_ONE_STRIP:
        n = -(-c // ABSORB_COLUMNS)
        return dict(layout="columns", panels=n, strips=1, rows_per_strip=s,
                    ctas=n)
    panels = -(-c // ABSORB_PANEL)
    want = -(-ABSORB_CTAS_PER_SM * n_sm // max(panels, 1))
    strips = max(1, min(want, -(-s // ABSORB_MIN_ROWS)))
    rows = -(-s // strips)
    strips = -(-s // rows)
    return dict(layout="panels", panels=panels, strips=strips,
                rows_per_strip=rows, ctas=panels * strips)


def absorb_rest_cells(plan: dict, s: int, c: int) -> list:
    """The (row lo, row hi, column lo, column hi) each CTA of ``plan`` reads
    for an S x C matrix, panel-major."""
    r = plan["rows_per_strip"]
    width = ABSORB_PANEL if plan["layout"] == "panels" else ABSORB_COLUMNS
    return [(k * r, min(s, (k + 1) * r), p * width, min(c, (p + 1) * width))
            for p in range(plan["panels"]) for k in range(plan["strips"])]


def absorb_rest_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version: the eager chain the sweep ran before the kernel."""
    has = w > 0
    first = torch.argmax(has.to(torch.uint8), dim=0)   # first max index
    won = has.any(dim=0)
    val = torch.gather(w, 0, first[None, :])[0]
    packed = (first.to(torch.int32) << 1) | (val == 1).to(torch.int32)
    return torch.where(won, packed, -1)


def absorb_rest(w: torch.Tensor) -> torch.Tensor:
    """Sweep-phase absorption: each column joins the EARLIEST winning seed
    row (first-claim, cluster.cpp:141-150).  w [S, C] int8.  Returns packed
    [C] int32 = (seed_row << 1) | rev, or -1.  One launch of the plan
    ``absorb_rest_plan`` gives (with more than one strip, after a memset of
    the output, where the strips' first wins meet)."""
    dev = w.device
    _check("absorb_rest w", w, torch.int8, 2, dev)
    s, c = w.shape
    if s >= 2 ** 30:
        raise ValueError(f"absorb_rest: {s} rows, the packing takes < 2^30")
    if not _on_card(w):
        return absorb_rest_plain(w)
    out = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return out
    plan = absorb_rest_plan(s, c, _sm_count(dev))
    fn = _ext.load("absorb_rest").absorb_rest_launch
    _raise_on(fn(w.data_ptr(), s, c, plan["strips"], plan["rows_per_strip"],
                 _ABSORB_LAYOUTS[plan["layout"]], out.data_ptr(),
                 _stream(dev)), "absorb_rest")
    absorb_rest.launches += 1
    return out


absorb_rest.launches = 0

_KERNELS = (bv_common, lis_filter, poa_align, join_expand, score_decide,
            greedy_owner, poa_thread, poa_rerank, poa_align_batch,
            gate_block, absorb_rest)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _KERNELS:
        fn.launches = 0
    lis_filter.shapes.clear()


def launches() -> dict:
    """Every kernel's launch count since the last ``reset_launches``."""
    return {fn.__name__: fn.launches for fn in _KERNELS}
