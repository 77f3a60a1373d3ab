"""Synthetic Nanopore-like reads from a seed, for runs without a real input.

Families are random transcripts of ``lo``..``hi`` bp; family sizes follow a
Zipf-like expression profile; every read is a full-length copy with ``err``
noise per base (35% deletions, 30% insertions, 35% substitutions, the mix of
tests/conftest.py's ``mutate``), vectorised so 8,192 reads of 300-3,000 bp
take about a second.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# the main path's input on the card: the toyset's scale (8,306 reads, 546
# gene clusters); chip_smoke.py and pipeline/profile_cluster.py both use it
MAIN_READS = 8192
MAIN_FAMILIES = 550
MAIN_SEED = 2024

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_BASES] = np.frombuffer(b"TGCA", np.uint8)


def mutate(rng: np.random.Generator, ref: np.ndarray, err: float
           ) -> np.ndarray:
    """A noisy copy of the base array ``ref``."""
    r = rng.random(len(ref))
    sub = (r >= 0.65 * err) & (r < err)
    base = np.where(sub, rng.choice(_BASES, len(ref)), ref)
    kept = r >= 0.35 * err
    counts = kept.astype(np.int64) + (kept & (r < 0.65 * err))
    out = base[np.repeat(np.arange(len(ref)), counts)]
    ins_at = (np.cumsum(counts) - counts)[counts == 2]
    out[ins_at] = rng.choice(_BASES, len(ins_at))
    return out


def synthetic_reads(n_reads: int, n_families: int, seed: int,
                    revcomp: bool = False, lo: int = 300, hi: int = 3000,
                    err: float = 0.08) -> List[Tuple[str, str, int]]:
    """[(name, seq, family)]; with ``revcomp`` half the reads are
    reverse-complemented (cDNA)."""
    rng = np.random.default_rng(seed)
    refs = [rng.choice(_BASES, int(rng.integers(lo, hi + 1)))
            for _ in range(n_families)]
    weights = 1.0 / np.arange(1, n_families + 1) ** 0.8
    fams = np.sort(rng.choice(n_families, n_reads, p=weights / weights.sum()))
    out = []
    for i, f in enumerate(fams):
        s = mutate(rng, refs[f], err)
        if revcomp and rng.random() < 0.5:
            s = _COMP[s][::-1]
        out.append((f"read{i}_fam{f}", s.tobytes().decode("ascii"), int(f)))
    return out


def write_fastq(reads, path: str) -> None:
    with open(path, "w") as fh:
        for name, seq, _f in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


# --------------------------------------------------------------------------
# POA graphs that stress the alignment kernel, plus the read aligned to each
# --------------------------------------------------------------------------

POA_CASES = ("long_insertion_skip", "long_insertion_take", "many_preds",
             "tied_preds", "long_chain", "short_read", "empty_graph",
             "inactive")


def _chain(g, letters: str, start: int = -1) -> List[int]:
    """Append a chain of new nodes (each its own group, in order) after node
    ``start`` (none if -1); returns the node ids."""
    ids = []
    prev = start
    for ch in letters:
        nid = g.add_node(ch)
        g.grp_order.append(nid)
        if prev >= 0:
            g.add_edge(prev, nid)
        ids.append(nid)
        prev = nid
    return ids


def _graph_with_branches(poa_mod, trunk: str, at: int, branches: List[str]):
    """A chain ``trunk`` whose node ``at`` gets, besides its trunk
    predecessor (edge 0), one predecessor for each branch: a chain of new
    nodes from node ``at - 1``.  Rank order: trunk[:at], the branches, the
    rest of the trunk."""
    g = poa_mod.POAGraph()
    head = _chain(g, trunk[:at])
    ends = [_chain(g, b, head[-1])[-1] for b in branches]
    tail = _chain(g, trunk[at:], head[-1])
    for e in ends:
        g.add_edge(e, tail[0])
    return g


def poa_cases(poa_mod=None, seed: int = 4096):
    """[(name, graph, read, active)] in ``POA_CASES`` order, for a read step
    of width 1024 or more.  ``poa_mod`` is the POA module whose graphs are
    built (``ops/poa.py`` by default; a test passes the reference's, which
    has the same classes); every graph is the same for the same seed.

    * long_insertion_*: a graph grown from a 300-base transcript and a read
      of it with 48 inserted bases, so the node after the insertion joins a
      predecessor 49 ranks back (beyond any shared-memory ring of rows) with
      one just before it; the read skips or takes the insertion;
    * many_preds: one node with 16 predecessors, 15 of them ends of short
      branches ranked just before it (still in flight) and its trunk
      predecessor ~30 ranks back; the read takes the 8th branch;
    * tied_preds: a two-node bubble whose letters both differ from the
      read's base there, so two predecessors score the same (edge order
      decides) ;
    * long_chain: a 400-node chain and a noisy read of it;
    * short_read: a 20-base read against a grown 300-node graph (one tile of
      a wide step);
    * empty_graph, inactive: lanes that must give no moves and best 0.
    """
    if poa_mod is None:
        from ..ops import poa as poa_mod
    rng = np.random.default_rng(seed)

    def rand(nb: int) -> str:
        return rng.choice(_BASES, nb).tobytes().decode("ascii")

    def noisy(s: str, err: float) -> str:
        arr = np.frombuffer(s.encode("ascii"), np.uint8)
        return mutate(rng, arr, err).tobytes().decode("ascii")

    def grow(reads):
        g = poa_mod.POAGraph()
        p = poa_mod.POAParams()
        for s in reads:
            poa_mod.add_alignment(g, poa_mod.align_local(g, s, p), s)
        return g

    ref = rand(300)
    ins = ref[:150] + rand(48) + ref[150:]
    grown = grow([ref, ins, noisy(ref, 0.04)])

    trunk = rand(120)
    branches = [rand(1 + i % 3) for i in range(15)]
    many = _graph_with_branches(poa_mod, trunk, 60, branches)
    many_read = noisy(trunk[:60], 0.03) + branches[7] + noisy(trunk[60:], 0.03)

    bubble = rand(80)
    z = bubble[40]
    x, y = [c for c in "ACGT" if c != z][:2]
    tied = _graph_with_branches(poa_mod, bubble[:40] + x + bubble[41:], 41,
                                [y])

    chain = rand(400)
    cases = {
        "long_insertion_skip": (grown, noisy(ref, 0.03), 1),
        "long_insertion_take": (grown, noisy(ins, 0.03), 1),
        "many_preds": (many, many_read, 1),
        "tied_preds": (tied, bubble, 1),
        "long_chain": (_graph_with_branches(poa_mod, chain, 1, []),
                       noisy(chain, 0.06), 1),
        "short_read": (grown, ref[200:220], 1),
        "empty_graph": (poa_mod.POAGraph(), noisy(ref, 0.03), 1),
        "inactive": (grown, noisy(ref, 0.03), 0),
    }
    return [(name, *cases[name]) for name in POA_CASES]


def rank_arrays(graph, n: int):
    """The rank-space arrays of ``poa_align`` for one lane, as int32 numpy:
    (pred_rows [n, 16], npred [n], letters [n]), and the node id at each
    rank.  Ranks follow ``graph.topo_groups()``; predecessor k of a rank is
    its k-th in-edge as a DP row (the predecessor's rank + 1; 0, the virtual
    start row, for a rank without predecessors)."""
    _, order = graph.topo_groups()
    rank_nodes = [nid for members in order for nid in members]
    if len(rank_nodes) > n:
        raise ValueError(f"graph of {len(rank_nodes)} nodes over N={n}")
    rank_of = {nid: r for r, nid in enumerate(rank_nodes)}
    pred_rows = np.zeros((n, 16), np.int32)
    npred = np.ones(n, np.int32)
    letters = np.zeros(n, np.int32)
    for r, nid in enumerate(rank_nodes):
        ins = graph.in_edges[nid]
        if len(ins) > 16:
            raise ValueError(f"node {nid} has {len(ins)} predecessors")
        letters[r] = ord(graph.letters[nid])
        npred[r] = max(len(ins), 1)
        for k, a in enumerate(ins):
            pred_rows[r, k] = rank_of[a] + 1
    return pred_rows, npred, letters, rank_nodes


# --------------------------------------------------------------------------
# match lists for lis_filter: join-shaped ones and ones that stress the scans
# --------------------------------------------------------------------------

I32_MIN = -(2 ** 31)
I32_MAX = 2 ** 31 - 1
LIS_CASES = ("all_invalid", "counts_1_2", "int32_min", "decreasing",
             "tied_runs", "invalid_holes", "bound_zero", "bound_above")


def match_lists(rng: np.random.Generator, b: int, m: int):
    """Join-shaped lists: counts in [m // 4, m], a colinear majority (a long
    LIS with gaps of up to 6, as related reads give) and a fifth of random
    matches, sorted by (p1, p2); pads are p1 0, p2 INT32_MAX, invalid.
    Returns int32 p1, p2, bool valid [b, m] and the counts [b]."""
    n_valid = rng.integers(m // 4, m + 1, size=b)
    p1 = np.sort(rng.integers(0, 8 * max(m, 1), (b, m)), axis=1)
    p2 = np.where(rng.random((b, m)) < 0.8,
                  p1 + rng.integers(-6, 7, (b, m)),
                  rng.integers(0, 8 * max(m, 1), (b, m)))
    order = np.lexsort((p2, p1), axis=1)
    p1 = np.take_along_axis(p1, order, axis=1)
    p2 = np.take_along_axis(p2, order, axis=1)
    valid = np.arange(m)[None, :] < n_valid[:, None]
    return (np.where(valid, p1, 0).astype(np.int32),
            np.where(valid, p2, I32_MAX).astype(np.int32), valid, n_valid)


def lis_cases(b: int, m: int, seed: int = 6):
    """[(name, p1, p2, valid, bound)] in ``LIS_CASES`` order: [b, m] batches
    (m >= 8) whose rows stress one rule of the LIS + filter + variance each;
    ``bound`` is the int the scans stop at.

    * all_invalid: every other row has no valid match;
    * counts_1_2: one or two valid matches a row, anywhere in it (variance
      0 for one anchor kept, +inf for two);
    * int32_min: some valid p2 are INT32_MIN (level 0: nothing is below
      it) and some INT32_MAX, the pad value;
    * decreasing: strictly decreasing p2 (an LIS of 1);
    * tied_runs: p2 in runs of equal values (ties do not extend the LIS);
    * invalid_holes: invalid slots inside every list;
    * bound_zero: a bound of 0 (nothing is scanned);
    * bound_above: every count below the bound, which is m.
    """
    rng = np.random.default_rng(seed)
    out = []
    for name in LIS_CASES:
        p1, p2, valid, n = match_lists(rng, b, m)
        if name == "all_invalid":
            valid[::2] = False
        elif name == "counts_1_2":
            valid[:] = False
            for r in range(b):
                at = np.sort(rng.choice(m, 1 + r % 2, replace=False))
                valid[r, at] = True
                # a far colinear second anchor is kept (n_dist 1); a lower
                # one ends the LIS at 1 (n_dist 0)
                p1[r, at] = 50 + 40 * np.arange(len(at))
                p2[r, at] = p1[r, at] + (20 if r % 4 == 1 else -90) * \
                    np.arange(len(at))
        elif name == "int32_min":
            hit = valid & (rng.random((b, m)) < 0.1)
            p2[hit] = np.where(rng.random(int(hit.sum())) < 0.7, I32_MIN,
                               I32_MAX)
        elif name == "decreasing":
            p2[:] = (10 * (m - np.arange(m)))[None, :]
        elif name == "tied_runs":
            p2[:] = (p1 // 4 * 4).astype(np.int32)
            p2[:, ::3] = np.maximum(p2[:, ::3] - 4, 0)
        elif name == "invalid_holes":
            valid &= rng.random((b, m)) < 0.7
        elif name == "bound_above":
            valid[:, m - 4:] = False
        bound = {"bound_zero": 0, "bound_above": m}.get(
            name, int(np.nonzero(valid.any(axis=0))[0].max(initial=-1)) + 1)
        out.append((name, p1, p2, valid, bound))
    return out


JOIN_CASES = ("one_hash_rows", "nk_one", "unequal_widths", "k16_high_hashes",
              "wide_class3", "wider_than_shared", "straddling_runs")
# the hash of straddling_runs' runs, mid-way in its hash space
RUN_HASH = 1 << 19


def _join_side(rng: np.random.Generator, b: int, width: int, nk: np.ndarray,
               hashes):
    """[b, width] int64 hashes sorted by (hash, pos) over each row's first
    nk entries (PAD_HASH after them, as in the sketch) and the co-sorted
    distinct int32 positions."""
    hs = np.full((b, width), 0xFFFFFFFF, np.int64)
    ps = np.zeros((b, width), np.int32)
    for r in range(b):
        h = np.asarray(hashes(int(nk[r])), np.int64)
        p = rng.permutation(2 * width)[:nk[r]].astype(np.int32)
        o = np.lexsort((p, h))
        hs[r, :nk[r]], ps[r, :nk[r]] = h[o], p[o]
    return hs, ps


def _run_hashes(rng: np.random.Generator, rows: int, space: int):
    """A ``hashes`` callable for ``_join_side`` that gives row r distinct
    hashes below ``space`` but a run of RUN_HASH: 40-90 entries for odd r,
    2-5 for even r."""
    row = iter(range(rows))

    def hashes(n):
        r = next(row)
        run = int(rng.integers(40, 91) if r % 2 else rng.integers(2, 6))
        h = rng.choice(np.setdiff1d(np.arange(space), [RUN_HASH]), n,
                       replace=False)
        h[:min(run, n)] = RUN_HASH
        return h
    return hashes


def join_cases(b: int = 8, seed: int = 16, wide: bool = True):
    """[(name, args, m_cap)] in ``JOIN_CASES`` order: the arguments of
    ``ops.kernels.join_expand`` before m_cap, as numpy arrays (rows, cols,
    row_ids, col_ids, row_tab, col_tab, hs_a, ps_a, hs_b, ps_b, nk), for b
    pairs whose tables stress one rule of the join each:

    * one_hash_rows: one hash over every entry of both rows (a total of
      1024^2, far past m_cap);
    * nk_one: one entry a read;
    * unequal_widths: a 1024-wide a table against a 4096-wide b table;
    * k16_high_hashes: k = 16 hashes, most >= 2^31, 0xFFFFFFFF (the pad
      value) among the real ones;
    * wide_class3: a class-3 width of 6144, above every fixed class;
    * wider_than_shared: 60,000 entries a row, wider than a block's shared
      memory holds (left out with ``wide=False``);
    * straddling_runs: full 1024-wide rows of distinct hashes but one,
      RUN_HASH, repeated over a run of 40-90 entries in odd rows and 2-5 in
      even ones, so that a run is longer than a merge-path share of a pair
      split over 64 threads (2048 / 64 = 32 entries of both rows) and spans
      two or more shares; a long run against a short one fits m_cap = 512,
      two long ones overflow it.

    Pairs repeat rows and columns; a-side reads have ids 0..b-1 and b-side
    reads b..2b-1, whose tables rows are listed in reverse."""
    rng = np.random.default_rng(seed)
    out = []
    for name in JOIN_CASES:
        if name == "wider_than_shared" and not wide:
            continue
        wa, wb, m_cap = {"unequal_widths": (1024, 4096, 512),
                         "k16_high_hashes": (2048, 2048, 2048),
                         "wide_class3": (6144, 6144, 2048),
                         "wider_than_shared": (60000, 60000, 2048),
                         "straddling_runs": (1024, 1024, 512)}.get(
            name, (1024, 1024, 128))
        nb = 4 if name == "wider_than_shared" else b
        hashes_b = None
        if name == "one_hash_rows":
            nk_a, nk_b = np.full(nb, wa), np.full(nb, wb)
            hashes = lambda n: np.full(n, 12345)  # noqa: E731
        elif name == "straddling_runs":
            nk_a, nk_b = np.full(nb, wa), np.full(nb, wb)
            hashes, hashes_b = (_run_hashes(rng, nb, 2 * RUN_HASH)
                                for _ in range(2))
        elif name == "nk_one":
            nk_a = nk_b = np.ones(nb, np.int64)
            hashes = lambda n: rng.integers(0, 3, n)  # noqa: E731
        else:
            nk_a = rng.integers(wa // 2, wa + 1, nb)
            nk_b = rng.integers(wb // 2, wb + 1, nb)
            if name == "k16_high_hashes":
                pool = np.array([2**31, 2**31 + 7, 2**32 - 1, 3 << 30, 9],
                                np.int64)
                hashes = lambda n: np.where(  # noqa: E731
                    rng.random(n) < 0.02, rng.choice(pool, n),
                    rng.integers(2**31, 2**32, n))
            else:
                hashes = lambda n, s=2 * wa: rng.integers(0, s, n)  # noqa
        hs_a, ps_a = _join_side(rng, nb, wa, nk_a, hashes)
        hs_b, ps_b = _join_side(rng, nb, wb, nk_b, hashes_b or hashes)
        nk = np.concatenate([nk_a, nk_b]).astype(np.int32)
        hs_b, ps_b = hs_b[::-1].copy(), ps_b[::-1].copy()
        ids = np.arange(nb, dtype=np.int64)
        rows = rng.integers(0, nb, nb).astype(np.int64)
        cols = rng.integers(0, nb, nb).astype(np.int64)
        out.append((name, (rows, cols, ids, ids + nb, ids, ids[::-1].copy(),
                           hs_a, ps_a, hs_b, ps_b, nk), m_cap))
    return out
