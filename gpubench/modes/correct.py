"""The ``correct`` mode: one job corrects one read set against its gene
clusters into ``corrected.fq``, ``uncorrected.fq`` and ``consensi.fq``.

A set stands for ``rattle cluster``'s output on RATTLE's toyset without
running it (``make_inputs``): its clusters are fitted to the counts of the
toyset's golden output, 546 clusters of which 175 have more than
``min_reads`` reads and get a consensus, while the rest hold the 739 reads
that ``uncorrected.fq`` gives.  Each cluster is one transcript, its reads
noisy full-length copies whose per-base qualities follow the mix's
``quality`` model, and ``clusters.out`` lists them as RATTLE's cluster step
writes them: clusters by their longest read, members longest first.

The reference runs RATTLE's correction (``reference/correct.py``) on a
sample of each set's clusters, chosen from the seed and the set's clusters
(``choose_sample``): the most reads, the most reads whose longest read
passes 2,046 bases, the fewest reads of those small enough to pass
uncorrected, and then clusters drawn by the seed until the sample holds
the mix's ``sample_share`` of the set's bases.  Every job's records of the
sampled clusters are compared byte for byte; the whole output is held to
counts: each input read in exactly one of corrected.fq and uncorrected.fq,
one consensus a cluster of more than ``min_reads`` reads and none for the
rest.

This module is imported by the harness and by the reference's worker
processes, so it imports nothing of the program and no torch.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from .. import hpsio, synth
from ..reference import correct as ref

OUTPUTS = ("corrected.fq", "uncorrected.fq", "consensi.fq")
SAMPLE = "sample.json"
# the numbers compared: how a job's numbers combine over the run, and the
# limit of the combined number (jobs with any number above 0; the most
# records of the sampled clusters that differ in a byte or are missing in
# one job; the most reads or clusters of one job its output misaccounts)
CHECKS = {"jobs_differing": ("sum", 0), "records_differing": ("max", 0),
          "reads_unaccounted": ("max", 0)}
# the reference with a guarantee broken, in the program's place: its POA's
# traceback prefers E (a gap in the graph) to F, one co-optimal alignment
# for another
CONTROLS = ("tiebreak_ef",)
# the reference's quality arithmetic in float32 where RATTLE's is float64:
# no control, since it changes a byte of a set only now and then, where a
# mean error lands on a rounding edge (PERF.md, section 2)
FLOAT32 = "float32"
# per-kernel launch counters of the program and the kernel each launch
# starts, held against the trace so that a trace that lost records fails
TRACE_CHECKED = {"poa_align": "poa_align_kernel",
                 "poa_thread": "poa_thread_kernel",
                 "poa_rerank": "poa_rerank_kernel"}
# spans a traced job records around the program's layers: (module, class or
# None, attribute, name); idle gaps of the device are named by them
SPANS = [("rattle_tpu_torch.io.fastx", None, "read_multiple_inputs", "parse"),
         ("rattle_tpu_torch.correct.driver", None, "build_packs", "packs"),
         ("rattle_tpu_torch.correct.runner", "PackRunner", "__call__",
          "runner"),
         ("rattle_tpu_torch.correct.pack_engine", "PackEngine", "_run_group",
          "group"),
         ("rattle_tpu_torch.correct.runner", None, "fix_msa_ends", "trim"),
         ("rattle_tpu_torch.correct.runner", None, "correct_read_pack",
          "correct_reads"),
         ("rattle_tpu_torch.correct.runner", None,
          "generate_consensus_vector", "consensus"),
         ("rattle_tpu_torch.correct.driver", None, "fix_msa_ends", "trim"),
         ("rattle_tpu_torch.correct.driver", None,
          "generate_consensus_vector", "consensus"),
         ("rattle_tpu_torch.io.fastx", None, "write_fastq", "write")]
# a pack of reads longer than this runs in the pack engine's widest groups
LONG_READ = 2046
# the cluster step's default -p (the configurations' repr_percentile)
REPR_PERCENTILE = 0.15
_SALT = 0x5A3C


def _share(n: int, w: np.ndarray) -> np.ndarray:
    """``n`` split over the weights ``w`` by largest remainders."""
    share = n * w / w.sum()
    out = np.floor(share).astype(np.int64)
    out[np.argsort(-(share - out), kind="stable")[:n - int(out.sum())]] += 1
    return out


def cluster_sizes(data: dict) -> np.ndarray:
    """Reads a cluster by rank, the same for every seed: weight 1 / rank **
    ``exponent`` over ``clusters`` ranks, the first ``clusters_above`` of
    them sharing every read but ``reads_below``, which the rest share."""
    n, above = data["clusters"], data["clusters_above"]
    w = 1.0 / np.arange(1, n + 1) ** data["exponent"]
    big = _share(data["reads"] - data["reads_below"], w[:above])
    small = _share(data["reads_below"], w[above:])
    if small.size and (small.min() < 1 or small.max() >= big.min()):
        raise ValueError(f"cluster sizes {big.min()}.. above and "
                         f"{small.min()}..{small.max()} below do not part")
    return np.concatenate([big, small])


def noisy_read(rng: np.random.Generator, tx: np.ndarray, err: float,
               quality: dict) -> Tuple[bytes, bytes]:
    """A noisy copy of the transcript ``tx`` (``synth.mutate``'s errors:
    35% deletions, 30% insertions, 35% bases drawn anew) and its Phred
    qualities: a base drawn anew or inserted takes round(N(``error``)), any
    other round(N(``base``)), each clipped to ``range``."""
    r = rng.random(len(tx))
    sub = (r >= 0.65 * err) & (r < err)
    base = np.where(sub, rng.choice(synth._BASES, len(tx)), tx)
    kept = r >= 0.35 * err
    counts = kept.astype(np.int64) + (kept & (r < 0.65 * err))
    src = np.repeat(np.arange(len(tx)), counts)
    seq, drawn = base[src], sub[src]
    ins_at = (np.cumsum(counts) - counts)[counts == 2]
    seq[ins_at] = rng.choice(synth._BASES, len(ins_at))
    drawn[ins_at] = True
    (mb, sb), (me, se) = quality["base"], quality["error"]
    q = np.where(drawn, rng.normal(me, se, len(seq)),
                 rng.normal(mb, sb, len(seq)))
    lo, hi = quality["range"]
    q = np.clip(np.rint(q), lo, hi).astype(np.uint8) + 33
    return seq.tobytes(), q.tobytes()


def make_inputs(slot: str, data: dict, seed: int, k: int
                ) -> Tuple[dict, int]:
    """Write pool set ``k`` of ``seed`` under ``slot``: ``reads.fq`` and its
    clusters as ``clusters.out``.  Every seed has the same cluster sizes and
    transcript lengths; the seed draws the bases, the noise, the qualities
    and the reads' order in the file.  Returns (inputs, work: the set's
    bases)."""
    sizes = cluster_sizes(data)
    n = len(sizes)
    lengths = synth.gene_sizes(1, n, 0.0, data["length_lo"],
                               data["length_hi"])[1]
    rng = np.random.default_rng([abs(seed), int(seed < 0), k])
    txs = [rng.choice(synth._BASES, int(x)) for x in lengths]
    of = np.repeat(np.arange(n), sizes)[rng.permutation(int(sizes.sum()))]
    reads = [noisy_read(rng, txs[c], data["error"], data["quality"])
             for c in of.tolist()]
    fastq = os.path.join(slot, "reads.fq")
    with open(fastq, "wb") as fh:
        fh.write(b"".join(b"@read%d_cluster%d\n%s\n+\n%s\n" % (i, c, s, q)
                          for i, (c, (s, q)) in enumerate(zip(of, reads))))
    # RATTLE's cluster step: reads sorted by length, longest first (file
    # order among equals); each cluster seeded by its longest read in that
    # order (cluster.cpp:124-166), its members sorted by length, then by
    # id, both descending, and its main read the one at repr_percentile of
    # them (get_main_seq, cluster.cpp:67-91)
    lens = np.array([len(s) for s, _q in reads])
    order = np.argsort(-lens, kind="stable")
    members: Dict[int, List[int]] = {}
    for i in order.tolist():
        members.setdefault(int(of[i]), []).append(i)
    clusters = []
    for m in members.values():
        m.sort(key=lambda i: (-lens[i], -i))
        main = m[int(len(m) * REPR_PERCENTILE)]
        clusters.append(((main, False, -1), [(i, False, -1) for i in m]))
    path = os.path.join(slot, "clusters.out")
    with open(path, "wb") as fh:
        fh.write(hpsio.dumps(clusters))
    inputs = {"fastq": fastq, "clusters": path, "seed": seed, "set": k,
              "sample_share": data["sample_share"]}
    return inputs, int(lens.sum())


def argv(config: dict, inputs: dict, out: str, device: str) -> List[str]:
    """The CLI arguments of one job (correct mode's flags, main.cpp:325-412)."""
    c = config["correct"]
    return ["correct", "-i", inputs["fastq"], "-c", inputs["clusters"],
            "-o", out, "-g", str(c["gap_occ"]), "-m", str(c["min_occ"]),
            "-s", str(c["split"]), "-r", str(c["min_reads"]),
            "--device", device]


def output(out: str) -> Dict[str, bytes]:
    got = {}
    for name in OUTPUTS:
        with open(os.path.join(out, name), "rb") as fh:
            got[name] = fh.read()
    return got


def choose_sample(sizes: List[int], longest: List[int], bases: List[int],
                  seed: int, k: int, share: float, min_reads: int
                  ) -> List[int]:
    """The clusters the reference corrects, from the seed and the set's
    clusters (reads, longest read, bases of each): (a) the most reads, (b)
    the most reads of those whose longest read passes ``LONG_READ``, (c)
    the fewest reads of those of at most ``min_reads``, the first of equals
    each, and (d) the rest in an order drawn from the seed until the sample
    holds ``share`` of the bases."""
    n = len(sizes)
    chosen = [int(np.argmax(sizes))]
    long_ = [c for c in range(n) if longest[c] > LONG_READ]
    if long_:
        chosen.append(max(long_, key=lambda c: (sizes[c], -c)))
    small = [c for c in range(n) if sizes[c] <= min_reads]
    if small:
        chosen.append(min(small, key=lambda c: (sizes[c], c)))
    chosen = list(dict.fromkeys(chosen))
    rng = np.random.default_rng([abs(seed), int(seed < 0), k, _SALT])
    need = share * sum(bases)
    have = sum(bases[c] for c in chosen)
    for c in rng.permutation(n).tolist():
        if have >= need:
            break
        if c not in chosen:
            chosen.append(c)
            have += bases[c]
    return sorted(chosen)


def read_fastq(path: str) -> List[ref.Record]:
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [ref.Record(lines[i].decode(), lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def reference(inputs: dict, config: dict, control: str = ""
              ) -> Dict[str, bytes]:
    """The three files as RATTLE's correct step writes them, in queue order,
    with the sample's clusters corrected by the plain reference and every
    other cluster standing in uncorrected (its reads as they came, its first
    read as its consensus: the right records in the right files, for the
    counts), and ``sample.json``: the sampled clusters, the input reads'
    names and the clusters' sizes, which ``compare`` reads.  ``control``
    names one of ``CONTROLS`` to break, or is ``FLOAT32``."""
    if control not in ("", FLOAT32) + CONTROLS:
        raise ValueError(f"no control {control!r}")
    ef = control == "tiebreak_ef"
    t0 = time.perf_counter()
    c = config["correct"]
    p = dict(split=c["split"], min_reads=c["min_reads"], gap_occ=c["gap_occ"],
             min_occ=c["min_occ"], err_ratio=ref.ERR_RATIO,
             float=np.float32 if control == FLOAT32 else np.float64)
    reads = read_fastq(inputs["fastq"])
    with open(inputs["clusters"], "rb") as fh:
        clusters = hpsio.loads(fh.read())
    members = []
    for cid, (main, mem) in enumerate(clusters):
        if main[2] != -1 or any(m[1] for m in mem):
            raise ValueError("the reference takes gene clusters on the "
                             "forward strand")
        members.append([ref.Record(f"{reads[m[0]].header},gene_cluster_{cid}",
                                   reads[m[0]].seq, reads[m[0]].qual)
                        for m in mem])
    sizes = [len(m) for m in members]
    sample = choose_sample(
        sizes, [max(len(r.seq) for r in m) for m in members],
        [sum(len(r.seq) for r in m) for m in members], inputs["seed"],
        inputs["set"], inputs["sample_share"], p["min_reads"])
    threads = int(os.environ.get("OMP_NUM_THREADS") or os.cpu_count() or 1)
    done = ref.correct_clusters({cid: members[cid] for cid in sample}, p,
                                threads, ef)

    corrected, uncorrected, small, consensi = [], [], [], []
    for cid, mem in enumerate(members):
        if cid in done:
            cor, unc, sm, cons = done[cid]
        else:                                   # stands in, uncorrected
            packs = ref.split_packs(mem, p["split"])
            big = [pk for pk in packs if len(pk) > p["min_reads"]]
            cor, unc = big, [[] for _ in big]
            sm = [r for pk in packs if len(pk) <= p["min_reads"] for r in pk]
            cons = big[0][0].seq if big else None
        corrected += [r for pack in cor for r in pack]
        uncorrected += [r for pack in unc for r in pack]
        small += sm
        if cons is not None:
            consensi.append(ref.Record(
                f"@gene_cluster_{cid} reads={len(mem)} labels=", cons,
                ref.CONSENSUS_QUALITY.encode() * len(cons)))
    print(f"reference: set {inputs['set']}, {len(sample)} of {len(members)} "
          f"clusters, {sum(sum(len(r.seq) for r in members[c]) for c in sample)}"
          f" bases, {threads} threads, {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
    info = {"clusters": sample, "sizes": sizes, "min_reads": p["min_reads"],
            "reads": [r.header[1:] for r in reads]}
    return {OUTPUTS[0]: b"".join(r.fastq() for r in corrected),
            OUTPUTS[1]: b"".join(r.fastq() for r in small + uncorrected),
            OUTPUTS[2]: b"".join(r.fastq() for r in consensi),
            SAMPLE: json.dumps(info).encode()}


_CID = re.compile(rb"gene_cluster_(\d+)")


def records(data: bytes) -> List[bytes]:
    """A fastq file's records, four lines each (a short last one too)."""
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [b"\n".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def _by_cluster(data: bytes, keep=None) -> Dict[int, List[bytes]]:
    """A fastq file's records by the cluster their header names (the last
    ``gene_cluster_<cid>``, -1 where none), in the file's order; only the
    clusters of ``keep`` where it is given."""
    out: Dict[int, List[bytes]] = {}
    for rec in records(data):
        m = _CID.findall(rec.split(b"\n", 1)[0])
        cid = int(m[-1]) if m else -1
        if keep is None or cid in keep:
            out.setdefault(cid, []).append(rec)
    return out


def compare(got: Dict[str, bytes], want: Dict[str, bytes]) -> Dict[str, int]:
    """One job's numbers of ``CHECKS``: the sampled clusters' records, in
    each file in their order, that differ in a byte or are missing or extra;
    and the input reads not in exactly one of corrected.fq and
    uncorrected.fq (and reads there that are no input's), with the clusters
    whose count of consensi is not one (more than ``min_reads`` reads) or
    none (the rest)."""
    info = json.loads(want[SAMPLE])
    sampled = set(info["clusters"])
    differing = 0
    for name in OUTPUTS:
        mine = _by_cluster(got.get(name, b""), sampled)
        theirs = _by_cluster(want[name], sampled)
        for cid in sampled:
            a, b = mine.get(cid, []), theirs.get(cid, [])
            differing += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

    seen: Dict[bytes, int] = {}
    for name in OUTPUTS[:2]:
        for rec in records(got.get(name, b"")):
            read = rec.split(b"\n", 1)[0][1:].split(b",", 1)[0]
            seen[read] = seen.get(read, 0) + 1
    names = {r.encode() for r in info["reads"]}
    unaccounted = sum(1 for r in names if seen.get(r, 0) != 1)
    unaccounted += sum(1 for r in seen if r not in names)
    cons = {cid: len(recs) for cid, recs in
            _by_cluster(got.get(OUTPUTS[2], b"")).items()}
    sizes = info["sizes"]
    unaccounted += sum(
        1 for cid, size in enumerate(sizes)
        if cons.get(cid, 0) != int(size > info["min_reads"]))
    unaccounted += sum(1 for cid in cons if not 0 <= cid < len(sizes))
    return {"jobs_differing": int(differing + unaccounted > 0),
            "records_differing": differing, "reads_unaccounted": unaccounted}
