# Copied from rattle_tpu/pipeline/stages.py (run_cluster_sharded on a DataMesh).
"""Stage bodies shared by the CLI and tests.

Mirrors the mode bodies of reference main.cpp:

* ``run_cluster``  = cluster mode (main.cpp:133-324) incl. --iso recursion
* ``cluster_summary_rows`` = cluster_summary mode (main.cpp:413-483)
* ``extract_clusters``     = extract_clusters mode (main.cpp:484-611)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..config import ClusterParams, InputParams
from ..io.fastx import Read, ReadSet, read_multiple_inputs_cluster, sort_read_set
from ..io.hpsio import Cluster, CSeq, ClusterSet
from ..ops.encode import reverse_complement_str
from ..utils import metrics


def load_cluster_inputs(input_csv: str, label_csv: str, inp: InputParams) -> ReadSet:
    """The cluster mode's reads: read, length-filtered and sorted (span
    ``cluster.parse`` of utils.metrics.GLOBAL)."""
    with metrics.GLOBAL.span("cluster.parse"):
        files = [f for f in input_csv.split(",") if f]
        labels = [l for l in label_csv.split(",") if l] if label_csv else []
        reads = read_multiple_inputs_cluster(files, labels, inp.raw,
                                             inp.lower_len, inp.upper_len)
        sort_read_set(reads)
    return reads


def run_cluster_sharded(input_csv: str, label_csv: str, inp: InputParams,
                        gene_params: ClusterParams, mesh,
                        verbose: bool = False) -> ClusterSet:
    """Per-rank-sharded cluster mode (SURVEY §8): each rank of ``mesh`` (a
    parallel.launch.DataMesh) parses only the metadata of all inputs (a
    streaming length scan) plus the full content of ITS contiguous slice of
    the length-sorted read list, and builds the sketch rows of that slice
    only.  Output is byte-identical to the unsharded path on every rank.

    The global-index contract (main.cpp:27,47) is preserved: original
    record indices are assigned during the metadata scan, before any
    sharding, so every rank agrees on them with no communication."""
    import numpy as np
    from ..cluster.bulk import BulkClusterEngine, run_engine, shard_plan
    from ..io.fastx import read_cluster_selection, scan_multiple_inputs_cluster

    files = [f for f in input_csv.split(",") if f]
    labels = [l for l in label_csv.split(",") if l] if label_csv else []
    lengths, anns = scan_multiple_inputs_cluster(
        files, labels, inp.raw, inp.lower_len, inp.upper_len)
    order = np.argsort(-lengths, kind="stable")
    sorted_lens = lengths[order]
    start, end, _n_pad = shard_plan(mesh.world, mesh.rank, len(order))
    wanted = order[start:end]
    local = read_cluster_selection(files, labels, inp.raw, inp.lower_len,
                                   inp.upper_len, wanted)
    local_seqs = [local[int(p)].seq for p in wanted]
    engine = BulkClusterEngine(local_seqs, gene_params, mesh=mesh,
                               shard=(sorted_lens, start))
    engine.progress = verbose
    clusters = run_engine(engine)
    # id translation needs only each sorted read's original index
    stubs = [Read("", "", str(int(anns[p])), "") for p in order]
    return run_cluster(stubs, gene_params, engine=lambda s, p: clusters)


def run_cluster(
    reads: ReadSet,
    gene_params: ClusterParams,
    iso: bool = False,
    iso_params: Optional[ClusterParams] = None,
    engine=None,
    verbose: bool = False,
) -> ClusterSet:
    """Cluster length-sorted reads; translate ids back to original file
    indices via the ann field (main.cpp:266-274, 302-314).

    ``engine(seqs, params)`` produces clusters over local (sorted) indices;
    defaults to the NumPy oracle.  The device engine plugs in here.
    """
    if engine is None:
        from ..cluster.oracle import cluster_reads as engine  # noqa: PLC0415

    import inspect
    kw = {}
    try:
        if "progress" in inspect.signature(engine).parameters:
            kw["progress"] = verbose
    except (TypeError, ValueError):
        pass

    seqs = [r.seq for r in reads]
    gene_clusters = engine(seqs, gene_params, **kw)

    if not iso:
        out: ClusterSet = []
        for c in gene_clusters:
            main = CSeq(int(reads[c.main_seq.seq_id].ann), c.main_seq.rev, c.main_seq.gene_id)
            members = [CSeq(int(reads[s.seq_id].ann), s.rev, s.gene_id) for s in c.seqs]
            out.append(Cluster(main, members))
        return out

    iso_params = iso_params or ClusterParams(kmer_size=11, t_s=0.3, t_v=25.0,
                                             is_rna=gene_params.is_rna)
    iso_clusters: ClusterSet = []
    for c in gene_clusters:
        # re-sort members: stable by seq_id desc then stable by length desc
        # (main.cpp:285-291); matches get_main_seq's order so usually a no-op
        c.seqs.sort(key=lambda s: -s.seq_id)
        c.seqs.sort(key=lambda s: -len(reads[s.seq_id].seq))

    grouped = False
    try:
        grouped = "groups" in inspect.signature(engine).parameters
    except (TypeError, ValueError):
        pass

    if grouped:
        # one batched pass over every gene cluster (pairs across gene
        # clusters are masked out on device; exact per-cluster semantics)
        import numpy as np
        all_seqs: List[str] = []
        groups: List[int] = []
        bases: List[int] = []
        for gid, c in enumerate(gene_clusters):
            bases.append(len(all_seqs))
            for s in c.seqs:
                all_seqs.append(reads[s.seq_id].seq)
                groups.append(gid)
        g_arr = np.asarray(groups, np.int32)
        sub = engine(all_seqs, iso_params, groups=g_arr, **kw)
        for ic in sub:
            gid = int(g_arr[ic.main_seq.seq_id])
            c = gene_clusters[gid]
            base = bases[gid]
            main_orig = int(
                reads[c.seqs[ic.main_seq.seq_id - base].seq_id].ann)
            members = [
                CSeq(int(reads[c.seqs[s.seq_id - base].seq_id].ann),
                     s.rev, gid)
                for s in ic.seqs
            ]
            iso_clusters.append(
                Cluster(CSeq(main_orig, ic.main_seq.rev, gid), members))
        return iso_clusters

    for gid, c in enumerate(gene_clusters):
        gene_seqs = [reads[s.seq_id].seq for s in c.seqs]
        sub = engine(gene_seqs, iso_params)
        for ic in sub:
            main_orig = int(reads[c.seqs[ic.main_seq.seq_id].seq_id].ann)
            members = [
                CSeq(int(reads[c.seqs[s.seq_id].seq_id].ann), s.rev, gid)
                for s in ic.seqs
            ]
            iso_clusters.append(Cluster(CSeq(main_orig, ic.main_seq.rev, gid), members))
    return iso_clusters


def cluster_summary_rows(reads: ReadSet, clusters: ClusterSet) -> List[str]:
    """CSV rows exactly as main.cpp:471-483 prints them.  ``reads`` must be in
    original file order (read via read_multiple_inputs, unsorted)."""
    rows: List[str] = []
    for cid, c in enumerate(clusters):
        if c.main_seq.gene_id == -1:
            for s in c.seqs:
                rows.append(f"{reads[s.seq_id].header},gene_cluster_{cid}")
        else:
            for s in c.seqs:
                rows.append(
                    f"{reads[s.seq_id].header},gene_cluster_{s.gene_id},transcript_cluster_{cid}"
                )
    return rows


def extract_clusters(
    reads: ReadSet,
    clusters: ClusterSet,
    out_dir: str,
    min_reads: int = 0,
    fastq: bool = False,
) -> None:
    """One fastx file per cluster (main.cpp:554-611): strict > min_reads,
    rev members reverse-complemented (quality intentionally NOT reversed,
    mirroring main.cpp:586-587's quirk), iso mode appends ",gene_id"."""
    for cid, c in enumerate(clusters):
        if len(c.seqs) <= min_reads:
            continue
        path = os.path.join(out_dir, f"cluster_{cid}.{'fq' if fastq else 'fa'}")
        with open(path, "w") as fh:
            for s in c.seqs:
                r = reads[s.seq_id]
                header = r.header if c.main_seq.gene_id == -1 else f"{r.header},{s.gene_id}"
                seq = reverse_complement_str(r.seq) if s.rev else r.seq
                fh.write(f"{header}\n{seq}\n")
                if fastq:
                    fh.write(f"{r.ann}\n{r.quality}\n")
