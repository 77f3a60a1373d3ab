"""The ``cluster`` mode: one job clusters one read set into ``clusters.out``.

A mode module holds all that belongs to one kind of job, so that the
harness needs no edit for a new one: the pool set's inputs and the work they
are (``make_inputs``), the job's CLI arguments (``argv``), its output
(``output``), the plain reference (``reference``), the numbers compared
(``CHECKS``, ``compare``), the launch counters a trace is held against
(``TRACE_CHECKED``) and the spans a traced job records (``SPANS``).

This module is imported by the harness and by the reference's worker
processes, so it imports nothing of the program and no torch.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

from .. import hpsio, synth
from ..reference import cluster as ref

OUTPUTS = ("clusters.out",)
# the numbers compared: how a job's numbers combine over the run, and the
# limit of the combined number (jobs whose clusters.out differs in a byte;
# the most reads of one job whose cluster, place or strand differ)
CHECKS = {"jobs_differing": ("sum", 0), "reads_misplaced": ("max", 0)}
# per-kernel launch counters of the program and the kernel each launch
# starts, held against the trace so that a trace that lost records fails
TRACE_CHECKED = {"join_expand": "join_expand_kernel",
                 "gate_block": "gate_tile_kernel"}
# spans a traced job records around the program's layers: (module, class or
# None, attribute, name); idle gaps of the device are named by them
SPANS = [("rattle_tpu_torch.pipeline.stages", None, "load_cluster_inputs",
          "parse"),
         ("rattle_tpu_torch.cluster.bulk", "BulkClusterEngine", "__init__",
          "engine_setup"),
         ("rattle_tpu_torch.cluster.bulk", "BulkClusterEngine", "cluster",
          "engine"),
         ("rattle_tpu_torch.cluster.bulk", "BulkClusterEngine", "_wave",
          "wave"),
         ("rattle_tpu_torch.io.hpsio", None, "write_clusters", "write")]


def make_inputs(slot: str, data: dict, seed: int, k: int
                ) -> Tuple[dict, int]:
    """Write pool set ``k`` of ``seed`` under ``slot``: ``data["samples"]``
    fastq files (default 1; the reads dealt to them in turn, a label each
    where there are several).  Returns (inputs, work: the set's reads)."""
    reads = synth.synthetic_reads(
        data["reads"], data["genes"], [abs(seed), int(seed < 0), k],
        exponent=data["exponent"], revcomp=data["revcomp"],
        lo=data["length_lo"], hi=data["length_hi"], err=data["error"])
    n = data.get("samples", 1)
    files = [os.path.join(slot, f"sample{i}.fq") for i in range(n)]
    for i, path in enumerate(files):
        synth.write_fastq(reads[i::n], path)
    labels = [f"S{i}" for i in range(n)] if n > 1 else []
    return {"fastq": files, "labels": labels}, len(reads)


def argv(config: dict, inputs: dict, out: str, device: str) -> List[str]:
    """The CLI arguments of one job (cluster mode's flags, main.cpp:134-179)."""
    c = config["cluster"]
    args = ["cluster", "-i", ",".join(inputs["fastq"]), "-o", out,
            "-k", str(c["kmer_size"]),
            "-s", str(c["score_threshold"]), "-v", str(c["max_variance"]),
            "-B", str(c["bv_start"]), "-b", str(c["bv_end"]),
            "-f", str(c["bv_falloff"]), "-p", str(c["repr_percentile"]),
            "--lower-length", str(c["lower_length"]),
            "--upper-length", str(c["upper_length"]), "--device", device]
    if inputs["labels"]:
        args += ["-l", ",".join(inputs["labels"])]
    return args + (["--rna"] if c["rna"] else [])


def output(out: str) -> Dict[str, bytes]:
    got = {}
    for name in OUTPUTS:
        with open(os.path.join(out, name), "rb") as fh:
            got[name] = fh.read()
    return got


def _params(config: dict, **kw) -> ref.Params:
    c = config["cluster"]
    return ref.Params(kmer_size=c["kmer_size"], t_s=c["score_threshold"],
                      t_v=c["max_variance"], bv_start=c["bv_start"],
                      bv_end=c["bv_end"], bv_falloff=c["bv_falloff"],
                      repr_percentile=c["repr_percentile"], rna=c["rna"],
                      **kw)


def read_fastq(path: str) -> List[str]:
    """The sequences of a fastq file, in its order (four lines a record)."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    return [lines[i + 1] for i in range(0, len(lines) - 3, 4)]


def reference(inputs: dict, config: dict, control: str = ""
              ) -> Dict[str, bytes]:
    """``clusters.out`` of the plain reference on the reads of the inputs'
    files, in their order.  ``control`` "match_cap" keeps each pair's first
    128 (pos1, pos2) matches only (the program's first tier, with no rescue
    of longer lists)."""
    t0 = time.perf_counter()
    kw = {"match_cap": dict(match_cap=128), "": {}}[control]
    c = config["cluster"]
    seqs = [s for path in inputs["fastq"] for s in read_fastq(path)]
    out = ref.cluster_file_order(seqs, _params(config, **kw),
                                 c["lower_length"], c["upper_length"])
    print(f"reference: {len(seqs)} reads, {ref.share_of_cores()} threads, "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return {OUTPUTS[0]: hpsio.dumps(
        [((m[0], m[1], -1), [(s, r, -1) for s, r in mem]) for m, mem in out])}


def compare(got: Dict[str, bytes], want: Dict[str, bytes]) -> Dict[str, int]:
    """One job's numbers of ``CHECKS``: whether its bytes differ, and the
    reads whose place (cluster index, position in it, strand) differs or is
    missing."""
    a_bytes, b_bytes = got[OUTPUTS[0]], want[OUTPUTS[0]]
    if a_bytes == b_bytes:
        return {"jobs_differing": 0, "reads_misplaced": 0}
    try:
        a = hpsio.loads(a_bytes)
    except ValueError:
        a = []
    b = hpsio.loads(b_bytes)

    def places(cl):
        return {m[0]: (ci, mi, m[1]) for ci, (_main, mem) in enumerate(cl)
                for mi, m in enumerate(mem)}

    pa, pb = places(a), places(b)
    moved = sum(1 for r, p in pb.items() if pa.get(r) != p)
    moved += sum(1 for r in pa if r not in pb)
    return {"jobs_differing": 1, "reads_misplaced": max(moved, 1)}
