# Copied from rattle_tpu/io/fastx.py.
"""Fasta/fastq IO with the reference's exact filtering semantics.

Mirrors reference fasta.cpp readers line by line in behavior (not code):

* ``read_fastq_full``    = read_fastq_file(file, sample_id)      fasta.cpp:207-270
* ``read_fastq_cluster`` = read_fastq_file(file, sample_id, idx, raw, lo, hi)
                           fasta.cpp:272-370 (quality dropped, ann = running
                           original index, N-filter, length window, the running
                           index smuggled through the last read's quality)
* ``read_fastq_plain``   = read_fastq_file(file)                 fasta.cpp:372-434
* ``read_fasta_full``    = read_fasta_file(file, sample_id)      fasta.cpp:33-104
                           (uppercased, quality = '~' per base)
* ``read_fasta_cluster`` = read_fasta_file(file, sample_id, ...) fasta.cpp:106-205
* ``write_fastq``        = write_fastq_file                      fasta.cpp:436-445
* ``sort_read_set``      = stable length-descending sort          fasta.cpp:458-464
* ``unzip_file``         = gz decompression                       fasta.cpp:7-31
  (deviation: decompresses to a temp dir instead of alongside the input, so
  read-only input directories work)

CRLF handling mirrors the reference: the first line decides (fasta.cpp:219),
then every line is stripped of its final character in CRLF mode.
"""

from __future__ import annotations

import gzip
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Read:
    """Mirror of read_t (fasta.hpp:7-12)."""

    header: str
    seq: str
    ann: str
    quality: str


ReadSet = List[Read]


def _lines(path: str) -> List[str]:
    with open(path, "r") as fh:
        raw = fh.read().split("\n")
    if raw and raw[-1] == "":
        raw.pop()
    crlf = bool(raw) and raw[0].endswith("\r")
    if crlf:
        raw = [ln[:-1] for ln in raw]
    return raw


def unzip_file(path: str) -> str:
    """Decompress .gz to a temp file named after the inner extension."""
    inner = os.path.basename(path)[: -len(".gz")] if path.endswith(".gz") else os.path.basename(path)
    tmpdir = tempfile.mkdtemp(prefix="rattle_tpu_gz_")
    out = os.path.join(tmpdir, inner)
    with gzip.open(path, "rb") as src, open(out, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return out


def read_fastq_full(path: str, sample_id: str = "") -> ReadSet:
    """Fastq reader keeping quality; header gets the sample suffix."""
    lines = _lines(path)
    result: ReadSet = []
    for i in range(0, len(lines) - 3, 4):
        result.append(Read(lines[i] + sample_id, lines[i + 1], lines[i + 2], lines[i + 3]))
    return result


def read_fastq_plain(path: str) -> ReadSet:
    """Fastq reader with no sample suffix (fasta.cpp:372-434, polish mode)."""
    lines = _lines(path)
    result: ReadSet = []
    for i in range(0, len(lines) - 3, 4):
        result.append(Read(lines[i], lines[i + 1], lines[i + 2], lines[i + 3]))
    return result


def read_fastq_cluster(
    path: str,
    sample_id: str,
    index: int,
    raw: bool,
    lower_len: int,
    upper_len: int,
) -> ReadSet:
    """Clustering fastq reader (fasta.cpp:272-370).

    Quality is dropped, ann carries the original record index (as a string),
    the index advances for every record including filtered ones, and the final
    surviving read's quality smuggles the running index out (fasta.cpp:363).
    Sequences are NOT uppercased (only the fasta readers uppercase).
    """
    lines = _lines(path)
    result: ReadSet = []
    n_count = 0
    for i in range(0, len(lines) - 3, 4):
        header = lines[i] + sample_id
        seq = lines[i + 1]
        ann = str(index)
        index += 1
        keep = raw or (lower_len <= len(seq) <= upper_len)
        if keep:
            if "N" in seq:
                n_count += 1
            else:
                result.append(Read(header, seq, ann, ""))
    if not result:
        raise ValueError(f"no reads survived filters in {path}")
    result[-1].quality = str(index)
    if n_count:
        print(f"\n{n_count}  reads contains N are skipped!", file=sys.stderr, flush=True)
    return result


def _fasta_records(path: str):
    lines = _lines(path)
    header: Optional[str] = None
    seq_parts: List[str] = []
    for ln in lines:
        if not ln:
            continue
        if ln[0] == ">":
            if header is not None:
                yield header, "".join(seq_parts)
            header = ln
            seq_parts = []
        else:
            seq_parts.append(ln)
    if header is not None:
        yield header, "".join(seq_parts)


def read_fasta_full(path: str, sample_id: str = "") -> ReadSet:
    """Fasta reader: uppercase, quality '~' per base (fasta.cpp:33-104)."""
    result: ReadSet = []
    for header, seq in _fasta_records(path):
        seq = seq.upper()
        result.append(Read(header + sample_id, seq, "+", "~" * len(seq)))
    return result


def read_fasta_cluster(
    path: str,
    sample_id: str,
    index: int,
    raw: bool,
    lower_len: int,
    upper_len: int,
) -> ReadSet:
    """Clustering fasta reader (fasta.cpp:106-205): uppercased, N/len filters."""
    result: ReadSet = []
    n_count = 0
    for header, seq in _fasta_records(path):
        seq = seq.upper()
        ann = str(index)
        index += 1
        keep = raw or (lower_len <= len(seq) <= upper_len)
        if keep:
            if "N" in seq:
                n_count += 1
            else:
                result.append(Read(header + sample_id, seq, ann, ""))
    if not result:
        raise ValueError(f"no reads survived filters in {path}")
    result[-1].quality = str(index)
    if n_count:
        print(f"\n{n_count}  reads contains N are skipped!", file=sys.stderr, flush=True)
    return result


def write_fastq(reads: ReadSet, path: str) -> None:
    with open(path, "w") as fh:
        for r in reads:
            fh.write(f"{r.header}\n{r.seq}\n{r.ann}\n{r.quality}\n")


def write_polish_summary(results: List[str], path: str) -> None:
    with open(path, "w") as fh:
        for r in results:
            fh.write(r + "\n")


def sort_read_set(reads: ReadSet) -> None:
    """Stable length-descending sort in place (fasta.cpp:458-464)."""
    reads.sort(key=lambda r: -len(r.seq))


_FASTQ_EXT = {"fq", "fastq"}
_FASTA_EXT = {"fa", "fasta"}


def _route(path: str):
    ext = path.rsplit(".", 1)[-1] if "." in path else ""
    if ext == "gz":
        path = unzip_file(path)
        ext = path.rsplit(".", 1)[-1] if "." in path else ""
    if ext in _FASTQ_EXT:
        return path, "fastq"
    if ext in _FASTA_EXT:
        return path, "fasta"
    raise ValueError("Input file format incorrect! Please use fasta/fastq file.")


def read_multiple_inputs_cluster(
    input_files: List[str],
    label_files: List[str],
    raw: bool,
    lower_len: int,
    upper_len: int,
) -> ReadSet:
    """Comma-separated multi-sample reader for cluster mode (main.cpp:16-64)."""
    no_labels = len(label_files) == 0
    if not no_labels and len(input_files) != len(label_files):
        raise ValueError("Number of input files and number of label files do not match")
    reads: ReadSet = []
    reads_num = 0
    for sample_number, f in enumerate(input_files):
        if not os.path.exists(f):
            raise FileNotFoundError(f)
        sample_label = "" if no_labels else "," + label_files[sample_number]
        path, kind = _route(f)
        if kind == "fastq":
            file_reads = read_fastq_cluster(path, sample_label, reads_num, raw, lower_len, upper_len)
        else:
            file_reads = read_fasta_cluster(path, sample_label, reads_num, raw, lower_len, upper_len)
        reads_num = int(file_reads[-1].quality)
        reads.extend(file_reads)
    return reads


def _iter_lines(path: str):
    """Streaming twin of _lines (first line decides CRLF; then every line
    loses its final character in CRLF mode, fasta.cpp:219)."""
    with open(path, "r") as fh:
        first = fh.readline()
        if not first:
            return
        if first.endswith("\n"):
            first = first[:-1]
        crlf = first.endswith("\r")
        yield first[:-1] if crlf else first
        for ln in fh:
            if ln.endswith("\n"):
                ln = ln[:-1]
            yield ln[:-1] if crlf else ln


def scan_multiple_inputs_cluster(
    input_files: List[str],
    label_files: List[str],
    raw: bool,
    lower_len: int,
    upper_len: int,
):
    """Streaming pass-1 metadata scan for per-host shard reading.

    Applies the exact survival rules of read_multiple_inputs_cluster
    (length window, N-filter, running original-index contract,
    main.cpp:16-64 / fasta.cpp:272-370) but retains NO sequence content.
    Returns (lengths, orig_indices) numpy arrays over the surviving reads
    in file-concatenation order — identical on every host, so the stable
    length-descending sort order (and hence every read's global id) is
    agreed without communication.
    """
    import numpy as np
    no_labels = len(label_files) == 0
    if not no_labels and len(input_files) != len(label_files):
        raise ValueError(
            "Number of input files and number of label files do not match")
    lengths: List[int] = []
    anns: List[int] = []
    index = 0
    for f in input_files:
        if not os.path.exists(f):
            raise FileNotFoundError(f)
        path, kind = _route(f)
        file_survivors = 0
        if kind == "fastq":
            it = _iter_lines(path)
            while True:
                rec = []
                for ln in it:
                    rec.append(ln)
                    if len(rec) == 4:
                        break
                if len(rec) < 4:
                    break
                seq = rec[1]
                ann = index
                index += 1
                if (raw or lower_len <= len(seq) <= upper_len) \
                        and "N" not in seq:
                    lengths.append(len(seq))
                    anns.append(ann)
                    file_survivors += 1
        else:
            for _header, seq in _fasta_records(path):
                ann = index
                index += 1
                # fasta readers uppercase before the N check
                if (raw or lower_len <= len(seq) <= upper_len) \
                        and "N" not in seq and "n" not in seq:
                    lengths.append(len(seq))
                    anns.append(ann)
                    file_survivors += 1
        if file_survivors == 0:
            raise ValueError(f"no reads survived filters in {path}")
    return (np.asarray(lengths, dtype=np.int64),
            np.asarray(anns, dtype=np.int64))


def read_cluster_selection(
    input_files: List[str],
    label_files: List[str],
    raw: bool,
    lower_len: int,
    upper_len: int,
    wanted,
) -> dict:
    """Pass-2 selective reader: full Read objects for the surviving-order
    positions in ``wanted`` only (per-host shard reading).  Parsing is
    per-file transient; only the selected reads are retained."""
    no_labels = len(label_files) == 0
    if not no_labels and len(input_files) != len(label_files):
        raise ValueError(
            "Number of input files and number of label files do not match")
    wanted = set(int(w) for w in wanted)
    out: dict = {}
    reads_num = 0
    surv = 0
    for sample_number, f in enumerate(input_files):
        if not os.path.exists(f):
            raise FileNotFoundError(f)
        sample_label = "" if no_labels else "," + label_files[sample_number]
        path, kind = _route(f)
        if kind == "fastq":
            file_reads = read_fastq_cluster(path, sample_label, reads_num,
                                            raw, lower_len, upper_len)
        else:
            file_reads = read_fasta_cluster(path, sample_label, reads_num,
                                            raw, lower_len, upper_len)
        reads_num = int(file_reads[-1].quality)
        for r in file_reads:
            if surv in wanted:
                out[surv] = r
            surv += 1
    return out


def read_multiple_inputs(input_files: List[str], label_files: List[str]) -> ReadSet:
    """Raw multi-sample reader for correct/summary modes (main.cpp:66-112)."""
    no_labels = len(label_files) == 0
    if not no_labels and len(input_files) != len(label_files):
        raise ValueError("Number of input files and number of label files do not match")
    reads: ReadSet = []
    for sample_number, f in enumerate(input_files):
        if not os.path.exists(f):
            raise FileNotFoundError(f)
        sample_label = "" if no_labels else "," + label_files[sample_number]
        path, kind = _route(f)
        if kind == "fastq":
            reads.extend(read_fastq_full(path, sample_label))
        else:
            reads.extend(read_fasta_full(path, sample_label))
    return reads
