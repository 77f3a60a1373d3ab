"""``rattle-tpu-torch`` command line: the clustering modes of the reference
binary (main.cpp:126-611) with its flags and defaults, on an explicit device.

    python -m rattle_tpu_torch.pipeline.cli MODE ...
      cluster -i reads.fq -o out --rna [--iso] [--device cpu] [--oracle]
      cluster_summary -i reads.fq -c out/clusters.out
      extract_clusters -i reads.fq -c out/clusters.out -o dir [--fastq]

``cluster`` runs on ``--device cuda`` (the default; it raises without a
card) or ``--device cpu`` (the kernels' plain versions).  ``correct``,
``polish`` and the multi-device options are not ported yet.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

from ..config import ClusterParams, InputParams
from ..device import DEVICES, resolve
from ..io import fastx, hpsio
from ..pipeline import stages


def _add_common_input(p):
    p.add_argument("-i", "--input", required=True,
                   help="input fasta/fastq file (required)")
    p.add_argument("-l", "--label", default="",
                   help="labels for the files in order of entry")


def _engine(args):
    if args.oracle:
        from ..cluster.oracle import cluster_reads
        return cluster_reads
    from ..cluster.bulk import cluster_reads_bulk
    kw = {"device": resolve(args.device)}
    if args.checkpoint_dir is not None:
        kw["checkpoint_dir"] = args.checkpoint_dir
    return functools.partial(cluster_reads_bulk, **kw)


def _cluster_params(args, kmer_size, t_s, t_v) -> ClusterParams:
    return ClusterParams(kmer_size=kmer_size, t_s=t_s, t_v=t_v,
                         bv_threshold=args.bv_start_threshold,
                         bv_min_threshold=args.bv_end_threshold,
                         bv_falloff=args.bv_falloff,
                         min_reads_cluster=args.min_reads_cluster,
                         repr_percentile=args.repr_percentile,
                         is_rna=args.rna)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    top = argparse.ArgumentParser(prog="rattle-tpu-torch")
    sub = top.add_subparsers(dest="mode", required=True)

    pc = sub.add_parser("cluster")
    _add_common_input(pc)
    pc.add_argument("-o", "--output", default=".")
    pc.add_argument("-t", "--threads", type=int, default=1)
    pc.add_argument("-k", "--kmer-size", type=int, default=10)
    pc.add_argument("-s", "--score-threshold", type=float, default=0.2)
    pc.add_argument("-v", "--max-variance", type=float, default=1000000)
    pc.add_argument("--iso", action="store_true")
    pc.add_argument("--iso-kmer-size", type=int, default=11)
    pc.add_argument("--iso-score-threshold", type=float, default=0.3)
    pc.add_argument("--iso-max-variance", type=float, default=25)
    pc.add_argument("-B", "--bv-start-threshold", type=float, default=0.4)
    pc.add_argument("-b", "--bv-end-threshold", type=float, default=0.2)
    pc.add_argument("-f", "--bv-falloff", type=float, default=0.05)
    pc.add_argument("-r", "--min-reads-cluster", type=int, default=0)
    pc.add_argument("-p", "--repr-percentile", type=float, default=0.15)
    pc.add_argument("--rna", action="store_true")
    pc.add_argument("--verbose", action="store_true")
    pc.add_argument("--raw", action="store_true")
    pc.add_argument("--lower-length", type=int, default=150)
    pc.add_argument("--upper-length", type=int, default=100000)
    pc.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the engine runs: cuda (default; fails "
                    "without a card) or cpu (the kernels' plain versions)")
    pc.add_argument("--oracle", action="store_true",
                    help="use the NumPy oracle engine instead of the device "
                    "engine")
    pc.add_argument("--checkpoint-dir", default=None,
                    help="phase-granular resume manifest dir (greedy pass + "
                    "each merge round; device engine only)")

    ps = sub.add_parser("cluster_summary")
    _add_common_input(ps)
    ps.add_argument("-c", "--clusters", required=True)

    pe = sub.add_parser("extract_clusters")
    _add_common_input(pe)
    pe.add_argument("-c", "--clusters", required=True)
    pe.add_argument("-o", "--output-folder", dest="output", default=".")
    pe.add_argument("-m", "--min-reads", type=int, default=0)
    pe.add_argument("--fastq", action="store_true")

    args = top.parse_args(argv)
    mode = args.mode
    labels = [l for l in args.label.split(",") if l]

    if mode == "cluster":
        if args.kmer_size > 16 or args.iso_kmer_size > 16:
            print("\nError: maximum kmer size = 16", file=sys.stderr)
            return 1
        print(f"RNA mode: {str(args.rna).lower()}", file=sys.stderr)
        engine = _engine(args)
        inp = InputParams(raw=args.raw, lower_len=args.lower_length,
                          upper_len=args.upper_length)
        reads = stages.load_cluster_inputs(args.input, args.label, inp)
        print(f"Reads: {len(reads)}")
        gp = _cluster_params(args, args.kmer_size, args.score_threshold,
                             args.max_variance)
        ip = _cluster_params(args, args.iso_kmer_size,
                             args.iso_score_threshold, args.iso_max_variance)
        clusters = stages.run_cluster(reads, gp, iso=args.iso, iso_params=ip,
                                      engine=engine, verbose=args.verbose)
        kind = "isoform" if args.iso else "gene"
        print(f"{kind} clustering done", file=sys.stderr)
        print(f"{len(clusters)} {kind} clusters found", file=sys.stderr)
        hpsio.write_clusters(clusters,
                             os.path.join(args.output, "clusters.out"))
        return 0

    files = [f for f in args.input.split(",") if f]
    reads = fastx.read_multiple_inputs(files, labels)
    clusters = hpsio.read_clusters(args.clusters)
    if mode == "cluster_summary":
        try:
            for row in stages.cluster_summary_rows(reads, clusters):
                print(row)
        except BrokenPipeError:  # e.g. piped into head; exit quietly
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        return 0
    stages.extract_clusters(reads, clusters, args.output,
                            min_reads=args.min_reads, fastq=args.fastq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
