"""The port's three kernels, each beside its plain PyTorch version.

* ``bv_common``  -- csrc/bv_common.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::bv_common_matmul.
* ``lis_filter`` -- csrc/lis_filter.cu, replaces
  rattle_tpu/ops/pallas_kernels.py::lis_filter_pallas.
* ``poa_align``  -- csrc/poa_align.cu, replaces
  rattle_tpu/ops/poa_pallas.py::poa_align_pallas.

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and takes the
plain version only because its tensors lie on the CPU; there is no fallback
from one to the other.  Each wrapper counts its kernel launches in a plain
integer attribute (``bv_common.launches``, ``lis_filter.launches``,
``poa_align.launches``) so a run can show that a path went through the kernel;
``lis_filter.shapes`` splits its count by (M, B).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _ext
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
                    seq: torch.Tensor, seq_len: torch.Tensor,
                    active: torch.Tensor, match: int = 5, mismatch: int = -4,
                    go: int = -8, ge: int = -6,
                    scratch: Optional[torch.Tensor] = None
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
    nn = torch.where(active > 0, n_nodes.clamp(max=n), 0)
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
              seq: torch.Tensor, seq_len: torch.Tensor, active: torch.Tensor,
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
    step's width, a runtime value); ``seq_len`` [B] <= W - 2; ``active`` [B].

    Returns (packed [B, W], count [B], best [B]): the traceback's diagonal
    moves as (rank + 1) << 16 | (pos + 1) in reverse order, their number,
    and the best score.  An inactive lane or an empty graph gives count 0
    and best 0.

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
    _check("poa_align seq", seq, torch.uint8, 2, dev)
    w = seq.shape[1]
    for name, v in (("n_nodes", n_nodes), ("seq_len", seq_len),
                    ("active", active)):
        _check(f"poa_align {name}", v, torch.int32, 1, dev, b)
    if (npred.shape[0] != b or seq.shape[0] != b
            or tuple(pred_rows.shape[:2]) != (b, n)):
        raise ValueError("poa_align: inputs must share [B, N]")
    if w < 128 or w > POA_MAX_W or w % 128 or n < 1:
        raise ValueError(f"poa_align: W must be a multiple of 128 in "
                         f"[128, {POA_MAX_W}] and N >= 1, got W={w} N={n}")
    if not _on_card(letters):
        return poa_align_plain(pred_rows, npred, letters, n_nodes, seq,
                               seq_len, active, match, mismatch, go, ge)
    need = poa_scratch_elems(b, n, w)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.int16, device=dev)
    else:
        _check("poa_align scratch", scratch, torch.int16, 1, dev)
        if scratch.numel() < need:
            raise ValueError(f"poa_align: scratch has {scratch.numel()} "
                             f"elements, needs {need}")
    packed = torch.zeros((b, w), dtype=torch.int32, device=dev)
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
                 active.data_ptr(), b, n, w, match, mismatch, go, ge,
                 base, base + plane, base + 2 * plane, packed.data_ptr(),
                 tlen.data_ptr(), best.data_ptr(),
                 None if stamps is None else stamps.data_ptr(),
                 _stream(dev)), "poa_align")
    poa_align.launches += 1
    return packed, tlen, best


poa_align.launches = 0

_KERNELS = (bv_common, lis_filter, poa_align)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _KERNELS:
        fn.launches = 0
    lis_filter.shapes.clear()


def launches() -> dict:
    """Every kernel's launch count since the last ``reset_launches``."""
    return {fn.__name__: fn.launches for fn in _KERNELS}
