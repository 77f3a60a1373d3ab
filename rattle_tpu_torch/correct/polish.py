# Copied from rattle_tpu/correct/polish.py.
"""Polish stage (reference main.cpp:612-762): re-cluster the consensi with
hard-coded params, re-correct, then rewrite headers with aggregated read
counts and the transcript->gene map."""

from __future__ import annotations

from typing import Callable, List, Optional

from ..config import POLISH_CLUSTER_PARAMS, POLISH_CORRECT_PARAMS, replace
from ..io.fastx import ReadSet, sort_read_set
from .driver import CorrectionResults, correct_reads


def polish(reads: ReadSet, is_rna: bool, labels: Optional[List[str]] = None,
           cluster_engine=None, msa_fn=None, pack_runner=None
           ) -> tuple:
    """Returns (consensi read set with rewritten headers, summary rows).

    ``reads`` must be the consensi fastq records; they are sorted and
    clustered in place here (main.cpp:659-670) — cluster seq_ids refer to the
    sorted order, with no original-index translation."""
    labels = labels or []
    sort_read_set(reads)

    cluster_params = replace(POLISH_CLUSTER_PARAMS, is_rna=is_rna)
    if cluster_engine is None:
        from ..cluster.oracle import cluster_reads as cluster_engine  # noqa: PLC0415
    clusters = cluster_engine([r.seq for r in reads], cluster_params)
    correction: CorrectionResults = correct_reads(
        clusters, reads, POLISH_CORRECT_PARAMS, labels=labels, msa_fn=msa_fn,
        pack_runner=pack_runner)

    gene_map = {}
    summary_rows: List[str] = []
    for cid, r in enumerate(correction.consensi):
        total_reads = 0
        label_counts = [0] * len(labels)
        gid = -1
        for s in clusters[cid].seqs:
            header = reads[s.seq_id].header
            total_reads += int(_leading_int(header.split("=", 1)[1]))
            for i, label in enumerate(labels):
                idx = header.find(label)
                if idx != -1:
                    sub = header[idx + 1:]
                    k = sub.find(":")
                    label_counts[i] += int(_leading_int(sub[k + 1:]))
            parts = header.split("_")
            if "transcript_cluster" in header:
                gene_id = int(_leading_int(parts[4]))
                if gene_id not in gene_map:
                    if gid == -1:
                        gid = gene_id
                    gene_map[gene_id] = gid
                else:
                    gid = gene_map[gene_id]
                summary_rows.append(
                    f"transcript_cluster_{int(_leading_int(parts[2]))}, "
                    f"gene_cluster_{gene_id}, new_cluster_{cid}")
            else:
                summary_rows.append(
                    f"gene_cluster_{int(_leading_int(parts[2]))}, new_cluster_{cid}")

        rcount = int(_leading_int(r.header.split("=", 1)[1]))
        if gid != -1:
            r.header = (f"@transcript_cluster_{cid} gene_cluster_{gid} "
                        f"generated_from_transcript_clusters={rcount} "
                        f"total_reads={total_reads} labels=")
        else:
            r.header = (f"@cluster_{cid} generated_from_consensi_clusters={rcount} "
                        f"total_reads={total_reads} labels=")
        for i, label in enumerate(labels):
            r.header += f"{label}:{label_counts[i]},"
    return correction.consensi, summary_rows


def _leading_int(s: str) -> str:
    """std::stoi semantics: parse the leading integer, skipping leading
    whitespace, allowing a sign."""
    s = s.lstrip()
    out = ""
    for i, ch in enumerate(s):
        if ch.isdigit() or (ch in "+-" and i == 0):
            out += ch
        else:
            break
    return out or "0"
