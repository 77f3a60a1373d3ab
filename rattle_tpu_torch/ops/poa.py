# Copied from rattle_tpu/ops/poa.py.
"""Partial-order alignment (POA) engine — reference-free MSA of read packs.

Replaces the reference's spoa dependency (correct.cpp:395-405: local/SW
alignment with scores match=5, mismatch=-4, gap_open=-8, gap_extend=-6,
then ``generate_multiple_sequence_alignment``).  The spoa submodule is not
vendored here; this is an independent implementation of the classic POA
algorithm (Lee, Grasso & Sharlow 2002) with affine gaps, written as an exact
executable SPEC that the batched device kernel is tested against.

Deterministic choices (documented because they define OUR msa semantics;
chosen by measuring toyset consensus containment against the spoa-built
goldens — see docs/CONSENSUS.md for the sweep):

* DP maximum tie-break: first cell in (topo-rank ascending, seq-pos
  ascending) order.
* Traceback preference in H state: diagonal (predecessors in edge insertion
  order) > F (gap in sequence, predecessors in order) > E (gap in graph) —
  spoa's traceback checks the vertical state before the horizontal one.
* Topological order: spoa-style iterative DFS over nodes in id order with
  aligned-node groups emitted together (see topo_groups).  Aligned groups
  are consecutive in rank, which makes one MSA column per group.

The E recurrence exploits ge >= go to become a running max (prefix scan),
which is also what makes the device kernel's row scan efficient.
"""

from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG = -(2**30)


def poa_order_mode() -> str:
    """Topological-order flavor: "incr" (default; insertion-maintained group
    order, what the pack engine computes on the device) or "dfs"
    (spoa-flavoured DFS re-rank per alignment, round-3 semantics).  Both are
    valid group-consecutive topological orders; they differ only in which
    co-optimal alignment the DP tie-breaks pick.  Toyset containment vs the
    spoa goldens measured for both in docs/CONSENSUS.md."""
    return os.environ.get("RATTLE_POA_TOPO", "incr")


@dataclass
class POAGraph:
    """Growable partial-order graph.  Nodes store raw characters (the
    reference's consensus counting distinguishes 'U' from 'T' and is
    case-sensitive, correct.cpp:105-110)."""

    letters: List[str] = field(default_factory=list)
    in_edges: List[List[int]] = field(default_factory=list)   # insertion order
    out_edges: List[List[int]] = field(default_factory=list)
    aligned: List[List[int]] = field(default_factory=list)    # other group members
    paths: List[List[int]] = field(default_factory=list)      # per added sequence
    # incremental group order ("incr" mode): group leaders (= creating node)
    # in column order, maintained by add_alignment.  Validity: every edge
    # a->b is only ever added when a directed path a->..->b already exists
    # (traceback rows only move to predecessors), so inserting each new
    # group right after its path-predecessor's group preserves a valid
    # group-consecutive topological order without any re-sort.
    grp_order: List[int] = field(default_factory=list)
    grp_leader: List[int] = field(default_factory=list)       # node -> leader

    def n_nodes(self) -> int:
        return len(self.letters)

    def add_node(self, ch: str) -> int:
        self.letters.append(ch)
        self.in_edges.append([])
        self.out_edges.append([])
        self.aligned.append([])
        self.grp_leader.append(len(self.letters) - 1)
        return len(self.letters) - 1

    def add_edge(self, a: int, b: int) -> None:
        if a == b:
            raise ValueError("self edge")
        if b not in self.out_edges[a]:
            self.out_edges[a].append(b)
            self.in_edges[b].append(a)

    # ---- topological order over aligned groups ----

    def topo_groups(self) -> Tuple[List[int], List[List[int]]]:
        """Returns (group_of_node, groups_in_rank_order); flavor per
        poa_order_mode()."""
        if poa_order_mode() == "incr":
            return self.topo_groups_incr()
        return self.topo_groups_dfs()

    def topo_groups_incr(self) -> Tuple[List[int], List[List[int]]]:
        """Insertion-maintained order (see grp_order)."""
        group_of = [-1] * self.n_nodes()
        order: List[List[int]] = []
        for leader in self.grp_order:
            members = [leader] + list(self.aligned[leader])
            gid = len(order)
            order.append(members)
            for m in members:
                group_of[m] = gid
        return group_of, order

    def topo_groups_dfs(self) -> Tuple[List[int], List[List[int]]]:
        """Iterative DFS in spoa's style: roots are visited in node-id order,
        a node pushes its unvisited predecessors (then its unvisited aligned
        members) and becomes valid once all of them are emitted; the first
        member of an aligned group reached by the DFS is the group leader
        and emits the whole group (leader first, then its aligned list in
        insertion order).  Empirically this ordering — through its effect on
        DP rank order and therefore on which co-optimal alignment the
        traceback picks as the graph grows — is what moves toyset consensus
        containment vs the spoa-built goldens from ~0.74 to ~0.88 mean
        (docs/CONSENSUS.md)."""
        n = self.n_nodes()
        marks = [0] * n
        lead = [True] * n
        group_of = [-1] * n
        order: List[List[int]] = []
        for i in range(n):
            if marks[i]:
                continue
            stack = [i]
            while stack:
                u = stack[-1]
                if marks[u] == 2:
                    stack.pop()
                    continue
                valid = True
                for a in self.in_edges[u]:
                    if marks[a] != 2:
                        stack.append(a)
                        valid = False
                if lead[u]:
                    for al in self.aligned[u]:
                        if marks[al] != 2:
                            stack.append(al)
                            lead[al] = False
                            valid = False
                marks[u] = 1
                if valid:
                    marks[u] = 2
                    if lead[u]:
                        members = [u] + list(self.aligned[u])
                        gid = len(order)
                        order.append(members)
                        for m in members:
                            group_of[m] = gid
                    stack.pop()
        if sum(len(g) for g in order) != n:
            raise RuntimeError("cycle in POA graph")
        return group_of, order

    # ---- MSA ----

    def msa(self) -> List[str]:
        """One gap-padded row per added sequence; one column per aligned
        group, in topological rank order."""
        group_of, order = self.topo_groups()
        col_of_group: Dict[int, int] = {}
        for col, members in enumerate(order):
            col_of_group[group_of[members[0]]] = col
        ncols = len(order)
        rows = []
        for path in self.paths:
            row = ["-"] * ncols
            for nid in path:
                row[col_of_group[group_of[nid]]] = self.letters[nid]
            rows.append("".join(row))
        return rows


@dataclass
class POAParams:
    match: int = 5
    mismatch: int = -4
    gap_open: int = -8
    gap_extend: int = -6


Alignment = List[Tuple[int, int]]  # (node_id or -1, seq_pos or -1)


def align_local(graph: POAGraph, seq: str, p: POAParams) -> Alignment:
    """Local (SW) affine alignment of ``seq`` against the graph."""
    assert p.gap_extend >= p.gap_open, "E-scan trick requires ge >= go"
    n = graph.n_nodes()
    if n == 0:
        return []
    group_of, order = graph.topo_groups()
    rank_nodes = [nid for members in order for nid in members]
    rank_of = {nid: r for r, nid in enumerate(rank_nodes)}
    L = len(seq)

    # rows: 0 = virtual start, r+1 = node with rank r
    H = np.zeros((n + 1, L + 1), dtype=np.int32)
    E = np.full((n + 1, L + 1), NEG, dtype=np.int32)
    F = np.full((n + 1, L + 1), NEG, dtype=np.int32)

    seq_arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    go, ge = p.gap_open, p.gap_extend

    pred_rows: List[List[int]] = []
    for r, nid in enumerate(rank_nodes):
        preds = [rank_of[a] + 1 for a in graph.in_edges[nid]]
        pred_rows.append(preds if preds else [0])

    for r, nid in enumerate(rank_nodes):
        row = r + 1
        sub = np.where(seq_arr == ord(graph.letters[nid]), p.match, p.mismatch)
        diag = np.full(L + 1, NEG, dtype=np.int64)
        f = np.full(L + 1, NEG, dtype=np.int64)
        for pr in pred_rows[r]:
            diag[1:] = np.maximum(diag[1:], H[pr][:-1].astype(np.int64) + sub)
            f = np.maximum(f, np.maximum(H[pr].astype(np.int64) + go,
                                         F[pr].astype(np.int64) + ge))
        f[0] = NEG
        a = np.maximum(0, np.maximum(diag, f))
        # E via prefix max: E[j] = ge*j + max_{j'<j}(A[j'] + go - ge*(j'+1))
        jj = np.arange(L + 1, dtype=np.int64)
        shifted = a + go - ge * (jj + 1)
        run = np.maximum.accumulate(shifted)
        e = np.full(L + 1, NEG, dtype=np.int64)
        e[1:] = ge * jj[1:] + run[:-1]
        F[row] = np.clip(f, NEG, None).astype(np.int32)
        E[row] = np.clip(e, NEG, None).astype(np.int32)
        H[row] = np.maximum(a, e).astype(np.int32)

    # first maximum in (rank, j) order
    flat = int(np.argmax(H))
    best_row, best_j = divmod(flat, L + 1)
    if H[best_row, best_j] <= 0:
        return [(-1, j) for j in range(L)]  # nothing aligned

    aln_rev: Alignment = []
    r, j = best_row, best_j
    state = "H"
    while True:
        if state == "H":
            if r == 0 or H[r, j] == 0:
                break
            nid = rank_nodes[r - 1]
            sub = p.match if (j > 0 and seq[j - 1] == graph.letters[nid]) else p.mismatch
            moved = False
            if j > 0:
                for pr in pred_rows[r - 1]:
                    if H[r, j] == H[pr, j - 1] + sub:
                        aln_rev.append((nid, j - 1))
                        r, j = pr, j - 1
                        moved = True
                        break
            if moved:
                continue
            if H[r, j] == F[r, j]:
                state = "F"
                continue
            if H[r, j] == E[r, j]:
                state = "E"
                continue
            raise RuntimeError("traceback stuck in H")
        elif state == "E":
            aln_rev.append((-1, j - 1))
            # extend-first: keep the gap running while it can (spoa-like;
            # docs/CONSENSUS.md sweep), open only when extension can't explain
            if E[r, j] != E[r, j - 1] + p.gap_extend \
                    and E[r, j] == H[r, j - 1] + p.gap_open:
                state = "H"
            j -= 1
        else:  # F
            nid = rank_nodes[r - 1]
            aln_rev.append((nid, -1))
            moved = False
            for pr in pred_rows[r - 1]:
                if F[r, j] == F[pr, j] + p.gap_extend:
                    r = pr
                    moved = True
                    break
                if F[r, j] == H[pr, j] + p.gap_open:
                    r = pr
                    state = "H"
                    moved = True
                    break
            if not moved:
                raise RuntimeError("traceback stuck in F")

    aln = aln_rev[::-1]
    first_j = next((sp for _, sp in aln if sp != -1), 0)
    last_j = next((sp for _, sp in reversed(aln) if sp != -1), -1)
    prefix = [(-1, x) for x in range(first_j)]
    suffix = [(-1, x) for x in range(last_j + 1, L)]
    return prefix + aln + suffix


def add_alignment(graph: POAGraph, aln: Alignment, seq: str) -> None:
    """Thread ``seq`` into the graph along ``aln``; records the node path.

    Also maintains the incremental group order: each run of brand-new groups
    is inserted, in path order, immediately BEFORE the next placed group the
    path touches (runs with no later placed target go at the end).  This is
    where the spoa-style DFS emits them too — a new chain node is the last
    unfinished predecessor of its successor, so the DFS pops it right before
    emitting the successor — which keeps the DP tie-break behavior close to
    the DFS re-rank while staying O(1) dispatches on device."""
    path: List[int] = []
    prev: Optional[int] = None
    pos_of = {g: i for i, g in enumerate(graph.grp_order)}

    def reindex() -> None:
        pos_of.clear()
        pos_of.update({g: i for i, g in enumerate(graph.grp_order)})

    pending: List[int] = []  # new leaders not yet placed (leading run)
    if not aln:  # empty graph: fresh chain
        aln = [(-1, j) for j in range(len(seq))]
    for nid, spos in aln:
        if spos == -1:
            continue  # gap in sequence: no node consumed
        ch = seq[spos]
        new_group = False
        if nid == -1:
            target = graph.add_node(ch)
            new_group = True
        else:
            if graph.letters[nid] == ch:
                target = nid
            else:
                target = None
                for other in graph.aligned[nid]:
                    if graph.letters[other] == ch:
                        target = other
                        break
                if target is None:
                    target = graph.add_node(ch)
                    group = [nid] + list(graph.aligned[nid])
                    graph.aligned[target] = list(group)
                    graph.grp_leader[target] = graph.grp_leader[nid]
                    for m in group:
                        graph.aligned[m].append(target)
        if new_group:
            pending.append(target)
        elif pending:
            # flush the leading run right before this placed group
            at = pos_of[graph.grp_leader[target]]
            graph.grp_order[at:at] = pending
            reindex()
            pending = []
        if prev is not None and prev != target:
            graph.add_edge(prev, target)
        prev = target
        path.append(target)
    if pending:  # whole read unaligned: chain goes at the end
        graph.grp_order.extend(pending)
    graph.paths.append(path)


def poa_msa(seqs: Sequence[str], p: Optional[POAParams] = None) -> List[str]:
    """spoa-equivalent pipeline: align+add each sequence, then MSA
    (correct.cpp:398-405)."""
    p = p or POAParams()
    g = POAGraph()
    for s in seqs:
        aln = align_local(g, s, p)
        add_alignment(g, aln, s)
    return g.msa()
