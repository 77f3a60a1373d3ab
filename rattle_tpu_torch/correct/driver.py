# Copied from rattle_tpu/correct/driver.py.
"""Error-correction stage driver (reference correct.cpp:311-563).

Pack building, two-round POA-MSA correction, and per-cluster consensus
assembly.  Deterministic ordering: the reference drains its pack queue with a
thread pool, so corrected/uncorrected/consensus ORDER is thread-schedule
dependent there; here packs are processed in queue order (cluster id, then
pack index), which is one of the reference's legal schedules.

The POA engine is pluggable: ``msa_fn(list_of_seqs) -> list_of_rows`` defaults
to the NumPy oracle; the pack runner (correct/runner.py) batches many packs
through the device kernel instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..config import CorrectParams
from ..io.fastx import Read, ReadSet, sort_read_set
from ..io.hpsio import ClusterSet
from ..ops.encode import reverse_complement_str
from ..ops.poa import POAParams, poa_msa
from .consensus import correct_read_pack, fix_msa_ends, generate_consensus_vector


@dataclass
class CorrectionResults:
    corrected: ReadSet = field(default_factory=list)
    uncorrected: ReadSet = field(default_factory=list)
    consensi: ReadSet = field(default_factory=list)
    checkpoint: object = None  # CorrectCheckpoint when resume is enabled


@dataclass
class Pack:
    original_cluster_id: int
    reads: ReadSet


def build_packs(clusters: ClusterSet, reads: ReadSet, split: int,
                min_reads: int) -> tuple:
    """Pack splitting (correct.cpp:328-370).  Mutates ``reads`` in place the
    way the reference does: rev members get reverse-complemented (quality
    reversed), and every clustered read's header gains the
    ",gene_cluster_N[,transcript_cluster_M]" suffix."""
    packs: List[Pack] = []
    uncorrected: ReadSet = []
    for cid, tc in enumerate(clusters):
        n_files = (len(tc.seqs) - 1) // split + 1
        gid = tc.main_seq.gene_id
        for nf in range(n_files):
            creads: ReadSet = []
            for j in range(nf, len(tc.seqs), n_files):
                ts = tc.seqs[j]
                r = reads[ts.seq_id]
                if ts.rev:
                    r.seq = reverse_complement_str(r.seq)
                    r.quality = r.quality[::-1]
                if gid == -1:
                    r.header = f"{r.header},gene_cluster_{cid}"
                else:
                    r.header = f"{r.header},gene_cluster_{gid},transcript_cluster_{cid}"
                creads.append(Read(r.header, r.seq, r.ann, r.quality))
            if len(creads) > min_reads:
                packs.append(Pack(cid, creads))
            else:
                uncorrected.extend(creads)
    return packs, uncorrected


def _parse_pack_labels(creads: ReadSet, labels: List[str]) -> tuple:
    """Header bookkeeping for the pack consensus record (correct.cpp:453-468)."""
    labelset = []
    gid = ""
    for r in creads:
        index = r.header.find(",")
        rest = r.header[index + 1:]
        i = rest.find(",")
        label = rest if i == -1 else rest[:i]
        labelset.append(label)
        index = r.header.find("gene_cluster")
        tail = r.header[index + 13:]
        num = ""
        for ch in tail:
            if ch.isdigit() or (ch == "-" and not num):
                num += ch
            else:
                break
        gid = str(int(num))
    label_result = ""
    for label in labels:
        label_result += f" {label}:{labelset.count(label)}"
    return gid, label_result


def process_pack(pack: Pack, p: CorrectParams, msa_fn) -> tuple:
    """One pack through the two-round correction (correct.cpp:393-469).

    Returns (corrected, uncorrected, pack_consensus_seq)."""
    creads = pack.reads
    msa = msa_fn([r.seq for r in creads])
    fix_msa_ends(creads, msa)
    corrected, uncorrected, _cv = correct_read_pack(
        creads, msa, p.min_occ, p.gap_occ, p.err_ratio)

    corrected_out = list(corrected)  # captured before second-round trimming
    second = [Read(r.header, r.seq, r.ann, r.quality) for r in corrected]
    sort_read_set(second)
    msa2 = msa_fn([r.seq for r in second])
    fix_msa_ends(second, msa2)
    cv = generate_consensus_vector(second, msa2)
    consensus = cv.consensus_string()
    return corrected_out, uncorrected, consensus


def correct_reads(clusters: ClusterSet, reads: ReadSet, p: CorrectParams,
                  labels: Optional[List[str]] = None,
                  msa_fn: Optional[Callable[[List[str]], List[str]]] = None,
                  pack_runner=None,
                  checkpoint_dir: Optional[str] = None,
                  verbose: bool = False) -> CorrectionResults:
    """Full correction stage (correct.cpp:311-563).

    ``checkpoint_dir`` enables pack-granular resume (utils/checkpoint.py):
    finished packs are replayed from the manifest, only the remainder is
    recomputed, and the assembled outputs are byte-identical to an
    uninterrupted run."""
    labels = labels or []
    if msa_fn is None:
        poa_params = POAParams(p.poa_match, p.poa_mismatch, p.poa_gap_open,
                               p.poa_gap_extend)
        msa_fn = lambda seqs: poa_msa(seqs, poa_params)  # noqa: E731

    packs, small_uncorrected = build_packs(clusters, reads, p.split, p.min_reads)
    res = CorrectionResults(uncorrected=list(small_uncorrected))

    gene_mode = clusters[0].main_seq.gene_id == -1 if clusters else True
    consensi: Dict[int, ReadSet] = {cid: [] for cid in range(len(clusters))}

    ckpt = None
    done = {}
    if checkpoint_dir is not None:
        from ..utils.checkpoint import CorrectCheckpoint, params_key
        # digest the actual inputs, not just their counts: reusing a
        # checkpoint dir after reads/clusters changed (same sizes) must
        # invalidate, or stale pack outputs would splice into the results
        import hashlib
        h = hashlib.sha256()
        for r in reads:
            h.update(r.header.encode())
            h.update(str(len(r.seq)).encode())
        for c in clusters:
            h.update(b"|%d:%d" % (c.main_seq.seq_id, c.main_seq.gene_id))
            for s in c.seqs:
                h.update(b",%d%d" % (s.seq_id, s.rev))
        ckpt = CorrectCheckpoint(checkpoint_dir, params_key(
            n_clusters=len(clusters), n_reads=len(reads), split=p.split,
            min_reads=p.min_reads, min_occ=p.min_occ, gap_occ=p.gap_occ,
            err_ratio=p.err_ratio, inputs=h.hexdigest()))
        done = ckpt.load()

    todo = [pk for i, pk in enumerate(packs) if i not in done]
    if pack_runner is not None:
        todo_outcomes = iter(pack_runner(todo, p, msa_fn))
    else:
        todo_outcomes = (process_pack(pk, p, msa_fn) for pk in todo)

    def outcomes_in_order():
        for i, _pk in enumerate(packs):
            if i in done:
                d = done[i]
                yield d.corrected, d.uncorrected, d.consensus
            else:
                out = next(todo_outcomes)
                if ckpt is not None:
                    from ..utils.checkpoint import PackResult
                    ckpt.record(PackResult(i, out[0], out[1], out[2]))
                yield out

    # progress over reads drained from the pack queue (correct.cpp:391)
    n_total = sum(len(pk.reads) for pk in packs) + len(small_uncorrected)
    n_done = len(small_uncorrected)

    for pack, (corrected, uncorrected, consensus) in zip(packs,
                                                         outcomes_in_order()):
        if verbose:
            from ..utils.metrics import print_progress
            print_progress(n_done, n_total)
            n_done += len(pack.reads)
        res.corrected.extend(corrected)
        res.uncorrected.extend(uncorrected)
        gid, label_result = _parse_pack_labels(pack.reads, labels)
        consensi[pack.original_cluster_id].append(
            Read(f"{gid},{len(pack.reads)},{label_result}", consensus, "+",
                 "K" * len(consensus)))

    # sequential per-cluster consensus pass (correct.cpp:488-556).  The
    # multi-pack POAs batch through the pack runner's device engine when
    # one is active (reference path correct.cpp:519-543 runs them on spoa
    # like everything else).
    multi = [cid for cid in range(len(clusters)) if len(consensi[cid]) > 1]
    batch_fn = getattr(pack_runner, "batch_msa", None)
    if multi and batch_fn is not None:
        multi_msas = dict(zip(multi, batch_fn(
            [[r.seq for r in consensi[cid]] for cid in multi], p)))
    else:
        multi_msas = {cid: msa_fn([r.seq for r in consensi[cid]])
                      for cid in multi}
    for cid in range(len(clusters)):
        packs_c = consensi[cid]
        total_reads = 0
        label_counts = [0] * len(labels)
        gid = 0
        for rit in packs_c:
            parts = rit.header.split(",")
            gid = int(parts[0])
            total_reads += int(parts[1])
            for i, label in enumerate(labels):
                idx = rit.header.find(label)
                if idx != -1:
                    sub = rit.header[idx + 1:]
                    k = sub.find(":")
                    num = ""
                    for ch in sub[k + 1:]:
                        if ch.isdigit():
                            num += ch
                        else:
                            break
                    label_counts[i] += int(num)
        labels_result = "".join(
            f"{label}:{label_counts[i]}," for i, label in enumerate(labels))

        if len(packs_c) > 1:
            msa = multi_msas[cid]
            fix_msa_ends(packs_c, msa)
            cv = generate_consensus_vector(packs_c, msa)
            consensus = cv.consensus_string()
            if not gene_mode:
                header = (f"@transcript_cluster_{cid} gene_cluster_{gid} "
                          f"reads={total_reads} labels={labels_result}")
            else:
                header = f"@gene_cluster_{cid} reads={total_reads} labels={labels_result}"
            res.consensi.append(Read(header, consensus, "+", "K" * len(consensus)))
        elif len(packs_c) == 1:
            if not gene_mode:
                header = (f"@transcript_cluster_{cid} gene_cluster_{gid} "
                          f"reads={total_reads} labels={labels_result}")
            else:
                header = f"@gene_cluster_{cid} reads={total_reads} labels={labels_result}"
            res.consensi.append(
                Read(header, packs_c[0].seq, "+", packs_c[0].quality))
    if ckpt is not None:
        # keep the manifest on disk until the caller has written the stage
        # outputs (CLI removes it via finalize); flush so nothing is lost
        ckpt.flush()
        res.checkpoint = ckpt
    return res
