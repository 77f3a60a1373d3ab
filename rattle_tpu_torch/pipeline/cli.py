"""``rattle-tpu-torch`` command line: the five modes of the reference binary
(main.cpp:126-767) with its flags and defaults, on an explicit device.

    python -m rattle_tpu_torch.pipeline.cli MODE ...
      cluster -i reads.fq -o out --rna [--iso] [--device cpu] [--oracle]
      cluster_summary -i reads.fq -c out/clusters.out
      extract_clusters -i reads.fq -c out/clusters.out -o dir [--fastq]
      correct -i reads.fq -c out/clusters.out -o out [--poa-backend host]
      polish -i out/consensi.fq -o out --rna [--summary] [--oracle]

``cluster``, ``correct`` and ``polish`` run on ``--device cuda`` (the
default; it raises without a card) or ``--device cpu`` (the kernels' plain
versions).  ``--poa-backend device`` (the default) aligns packs on the
device pack engine; ``host`` runs the Python POA oracle instead.  With
``--poa-backend device``, RATTLE_POA_BACKEND=lockstep runs the lockstep
runner instead of the pack engine (graphs on the host, one
``poa_align_batch`` launch a read step) and RATTLE_POA_BACKEND=native every
pack on the host aligner; both write the same files.  The host aligner uses
``native/rattle_native.cpp``, which the port compiles into
``build/rattle_tpu_torch/librattle_native.so`` at first use.

Multi-process runs follow the JAX package's launch contract: with
RATTLE_COORDINATOR (host:port of rank 0), RATTLE_NUM_PROCESSES and
RATTLE_PROCESS_ID set, every rank joins one gloo process group before
anything else, runs on ``cuda:{rank % cards}`` (or the CPU), and the cluster
engine decides over all ranks (``--mesh-devices``; ``--shard-input`` makes
each rank parse only its slice of the reads).  Every rank computes the same
outputs; only rank 0 writes them, in every mode.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

from ..config import ClusterParams, CorrectParams, InputParams
from ..device import DEVICES
from ..io import fastx, hpsio
from ..parallel import launch
from ..pipeline import stages
from ..utils import metrics


def _add_common_input(p):
    p.add_argument("-i", "--input", required=True,
                   help="input fasta/fastq file (required)")
    p.add_argument("-l", "--label", default="",
                   help="labels for the files in order of entry")


def _engine(args, dev, mesh):
    if args.oracle:
        from ..cluster.oracle import cluster_reads
        return cluster_reads
    from ..cluster.bulk import cluster_reads_bulk
    kw = {"device": dev, "mesh": mesh}
    if getattr(args, "checkpoint_dir", None) is not None:
        kw["checkpoint_dir"] = args.checkpoint_dir
    return functools.partial(cluster_reads_bulk, **kw)


def _mesh(args, dev):
    """The DataMesh the cluster engine on ``dev`` decides over (None: every
    rank runs the whole engine, or the oracle runs on no device).
    ``--mesh-devices`` 0 spans every rank, 1 keeps each rank unsharded;
    ``--shard-input`` needs every rank.  Raises ValueError for any other
    count."""
    world = launch.process_count()
    n = getattr(args, "mesh_devices", 0)
    if n not in (0, 1, world):
        raise ValueError(f"--mesh-devices {n} is neither 0, 1 nor the world "
                         f"size {world} (one device a rank)")
    shard = getattr(args, "shard_input", False)
    if shard and n == 1 and world > 1:
        raise ValueError(f"--shard-input needs the engine over all {world} "
                         "ranks, not --mesh-devices 1")
    if dev is not None and (shard or (n or world) > 1):
        return launch.data_mesh(dev)
    return None


def _pack_runner(args, dev):
    """The correct/polish POA executor: the pack engine on ``dev``, or
    None (the Python POA oracle) for ``--poa-backend host``."""
    if args.poa_backend == "host":
        return None
    from ..correct.runner import make_pack_runner
    return make_pack_runner(dev)


def _report_poa(runner) -> None:
    """Where the packs ran, and why any went to the host aligner: the
    pack engine's packs, and the lockstep and native backends' when
    RATTLE_POA_BACKEND chose them."""
    if runner is None:
        return
    nat = runner.native
    if nat["packs"]:
        print(f"POA packs (native): {nat['packs']} on the host aligner "
              f"({nat['bases']} bases)", file=sys.stderr)
    ls = runner.lockstep.stats if runner.lockstep is not None else None
    if ls is not None:
        print(f"POA packs (lockstep): {ls['device_packs']} on the device "
              f"({ls['device_bases']} bases, {ls['steps']} steps, "
              f"{ls['t_align_s']:.2f} s aligning, {ls['t_host_s']:.2f} s "
              f"on the host), {ls['fallback_packs']} on the host aligner "
              f"({ls['host_bases']} bases, {ls['t_fallback_s']:.2f} s)",
              file=sys.stderr)
    st = runner.engine.stats
    if (nat["packs"] or ls is not None) \
            and not (st["device_packs"] or st["fallback_packs"]):
        return
    causes = ", ".join(f"{k[3:]} {v}" for k, v in st.items()
                       if k.startswith("fb_") and v)
    print(f"POA packs: {st['device_packs']} on the device "
          f"({st['device_bases']} bases, {st['steps']} steps), "
          f"{st['fallback_packs']} on the host ({st['host_bases']} bases"
          f"{'; ' + causes if causes else ''})", file=sys.stderr)


def _add_device(p, what: str):
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help=f"where {what} runs: cuda (default; fails without "
                   "a card) or cpu (the kernels' plain versions)")


def _add_poa_backend(p):
    p.add_argument("--poa-backend", choices=("device", "host"),
                   default="device",
                   help="POA executor: device = the pack engine on "
                   "--device, host = the Python POA oracle")


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
    # multi-process launch contract: join the process group before anything
    # else; every rank parses the same inputs (global-index contract of
    # main.cpp:27,47) and computes identical outputs; only rank 0 writes
    distributed = launch.init_distributed()
    is_writer = launch.process_index() == 0
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
    _add_device(pc, "the engine")
    pc.add_argument("--oracle", action="store_true",
                    help="use the NumPy oracle engine instead of the device "
                    "engine")
    pc.add_argument("--checkpoint-dir", default=None,
                    help="phase-granular resume manifest dir (greedy pass + "
                    "each merge round; device engine only; on several "
                    "ranks rank 0 writes it and every rank reads it)")
    pc.add_argument("--mesh-devices", type=int, default=0,
                    help="ranks the engine's reads axis spans: 0 = every "
                    "rank of the process group, 1 = each rank runs the "
                    "whole engine (one device a rank)")
    pc.add_argument("--shard-input", action="store_true",
                    help="multi-process: each rank parses only the metadata "
                    "of all inputs plus the content of its contiguous slice "
                    "of the length-sorted reads (incompatible with --iso/"
                    "--oracle/--checkpoint-dir)")

    pco = sub.add_parser("correct")
    _add_common_input(pco)
    pco.add_argument("-c", "--clusters", required=True)
    pco.add_argument("-o", "--output", default=".")
    pco.add_argument("-g", "--gap-occ", type=float, default=0.3)
    pco.add_argument("-m", "--min-occ", type=float, default=0.3)
    pco.add_argument("-s", "--split", type=int, default=200)
    pco.add_argument("-r", "--min-reads", type=int, default=5)
    pco.add_argument("-t", "--threads", type=int, default=1)
    pco.add_argument("--verbose", action="store_true")
    _add_poa_backend(pco)
    _add_device(pco, "the pack engine")
    pco.add_argument("--checkpoint-dir", default=None,
                     help="pack-granular resume manifest dir")

    ps = sub.add_parser("cluster_summary")
    _add_common_input(ps)
    ps.add_argument("-c", "--clusters", required=True)

    pe = sub.add_parser("extract_clusters")
    _add_common_input(pe)
    pe.add_argument("-c", "--clusters", required=True)
    pe.add_argument("-o", "--output-folder", dest="output", default=".")
    pe.add_argument("-m", "--min-reads", type=int, default=0)
    pe.add_argument("--fastq", action="store_true")

    pp = sub.add_parser("polish")
    pp.add_argument("-i", "--input", required=True)
    pp.add_argument("-o", "--output-folder", dest="output", default=".")
    pp.add_argument("-l", "--label", default="")
    pp.add_argument("-t", "--threads", type=int, default=1)
    pp.add_argument("--rna", action="store_true")
    pp.add_argument("--verbose", action="store_true")
    pp.add_argument("--summary", action="store_true")
    _add_poa_backend(pp)
    _add_device(pp, "the cluster engine and the pack engine")
    pp.add_argument("--oracle", action="store_true",
                    help="use the NumPy oracle cluster engine")

    args = top.parse_args(argv)
    mode = args.mode
    labels = [l for l in args.label.split(",") if l]
    dev = None
    on_device = (mode in ("cluster", "polish") and not args.oracle) or \
        (mode in ("correct", "polish") and args.poa_backend != "host")
    if on_device:
        dev = launch.rank_device(args.device)
        if distributed:
            print(f"rank {launch.process_index()} of "
                  f"{launch.process_count()} on {dev}", file=sys.stderr)

    if mode == "cluster":
        if args.kmer_size > 16 or args.iso_kmer_size > 16:
            print("\nError: maximum kmer size = 16", file=sys.stderr)
            return 1
        print(f"RNA mode: {str(args.rna).lower()}", file=sys.stderr)
        if args.shard_input and (args.iso or args.oracle
                                 or args.checkpoint_dir):
            print("--shard-input is incompatible with --iso/--oracle/"
                  "--checkpoint-dir", file=sys.stderr)
            return 1
        try:
            mesh = _mesh(args, dev)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        inp = InputParams(raw=args.raw, lower_len=args.lower_length,
                          upper_len=args.upper_length)
        gp = _cluster_params(args, args.kmer_size, args.score_threshold,
                             args.max_variance)
        if args.shard_input:
            clusters = stages.run_cluster_sharded(
                args.input, args.label, inp, gp, mesh, verbose=args.verbose)
            kind = "gene"
        else:
            reads = stages.load_cluster_inputs(args.input, args.label, inp)
            print(f"Reads: {len(reads)}")
            ip = _cluster_params(args, args.iso_kmer_size,
                                 args.iso_score_threshold,
                                 args.iso_max_variance)
            clusters = stages.run_cluster(
                reads, gp, iso=args.iso, iso_params=ip,
                engine=_engine(args, dev, mesh), verbose=args.verbose)
            kind = "isoform" if args.iso else "gene"
        print(f"{kind} clustering done", file=sys.stderr)
        print(f"{len(clusters)} {kind} clusters found", file=sys.stderr)
        if is_writer:
            with metrics.GLOBAL.span("cluster.write"):
                hpsio.write_clusters(
                    clusters, os.path.join(args.output, "clusters.out"))
        return 0

    if mode == "polish":
        from ..correct.polish import polish as run_polish
        runner = _pack_runner(args, dev)
        engine = _engine(args, dev, _mesh(args, dev))
        reads = fastx.read_fastq_plain(args.input)
        consensi, summary_rows = run_polish(
            reads, args.rna, labels, cluster_engine=engine,
            pack_runner=runner)
        if args.summary and is_writer:
            fastx.write_polish_summary(
                summary_rows, os.path.join(args.output, "polish_summary.tsv"))
        if is_writer:
            fastx.write_fastq(consensi,
                              os.path.join(args.output, "transcriptome.fq"))
        _report_poa(runner)
        print("Done", file=sys.stderr)
        return 0

    files = [f for f in args.input.split(",") if f]
    reads = fastx.read_multiple_inputs(files, labels)
    clusters = hpsio.read_clusters(args.clusters)
    if mode == "correct":
        from ..correct.driver import correct_reads
        runner = _pack_runner(args, dev)
        cp = CorrectParams(min_occ=args.min_occ, gap_occ=args.gap_occ,
                           split=args.split, min_reads=args.min_reads)
        # every rank corrects every pack; only rank 0 keeps the manifest
        res = correct_reads(clusters, reads, cp, labels=labels,
                            pack_runner=runner,
                            checkpoint_dir=args.checkpoint_dir
                            if is_writer else None,
                            verbose=args.verbose)
        if is_writer:
            fastx.write_fastq(res.corrected,
                              os.path.join(args.output, "corrected.fq"))
            fastx.write_fastq(res.uncorrected,
                              os.path.join(args.output, "uncorrected.fq"))
            fastx.write_fastq(res.consensi,
                              os.path.join(args.output, "consensi.fq"))
        if res.checkpoint is not None:
            res.checkpoint.finalize()  # stage artifacts are now the checkpoint
        _report_poa(runner)
        print("Done", file=sys.stderr)
        return 0
    if mode == "cluster_summary":
        try:
            for row in stages.cluster_summary_rows(reads, clusters):
                print(row)
        except BrokenPipeError:  # e.g. piped into head; exit quietly
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        return 0
    if is_writer:
        stages.extract_clusters(reads, clusters, args.output,
                                min_reads=args.min_reads, fastq=args.fastq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
