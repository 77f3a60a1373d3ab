# Copied from rattle_tpu/io/hpsio.py.
"""Cluster-store serialization compatible with RATTLE's `clusters.out`.

The reference serializes ``std::vector<cluster_t>`` through the hps library
(reference: main.cpp:275,322 ``hps::to_stream``; cluster.hpp:15-23,30-38 define
the field order ``seq_id, rev, gene_id`` then ``main_seq, seqs``).  The wire
format, reverse-engineered from the golden ``toyset/rna/output/clusters.out``:

* unsigned sizes  -> LEB128 varint
* signed ints     -> zigzag + LEB128 varint
* bool            -> one raw byte
* vector<T>       -> varint length followed by the elements

Two on-disk layouts exist in the wild: the current reference writes
``cseq_t{seq_id, rev, gene_id}`` while older builds (which produced the bundled
golden toyset outputs) wrote ``cseq_t{seq_id, rev}``.  ``read_clusters``
auto-detects which layout a file uses by attempting both parses and keeping the
one that consumes the stream exactly.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import List


@dataclass
class CSeq:
    """Cluster member: reference cluster.hpp:10-24."""

    seq_id: int
    rev: bool
    gene_id: int = -1


@dataclass
class Cluster:
    """Cluster: representative + members (reference cluster.hpp:26-39)."""

    main_seq: CSeq
    seqs: List[CSeq] = field(default_factory=list)


ClusterSet = List[Cluster]


def _write_varint(buf: io.BytesIO, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            buf.write(bytes([byte | 0x80]))
        else:
            buf.write(bytes([byte]))
            return


def _zigzag_encode(value: int) -> int:
    return ((value << 1) ^ (value >> 63)) & ((1 << 64) - 1)


def _zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            if self.pos >= len(self.data):
                raise EOFError("truncated varint")
            byte = self.data[self.pos]
            self.pos += 1
            result |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return result
            shift += 7

    def signed(self) -> int:
        return _zigzag_decode(self.varint())

    def boolean(self) -> bool:
        if self.pos >= len(self.data):
            raise EOFError("truncated bool")
        byte = self.data[self.pos]
        self.pos += 1
        return byte != 0

    @property
    def exhausted(self) -> bool:
        return self.pos == len(self.data)


def _parse(data: bytes, with_gene_id: bool) -> ClusterSet:
    reader = _Reader(data)
    n_clusters = reader.varint()

    def cseq() -> CSeq:
        seq_id = reader.signed()
        rev = reader.boolean()
        gene_id = reader.signed() if with_gene_id else -1
        return CSeq(seq_id, rev, gene_id)

    clusters: ClusterSet = []
    for _ in range(n_clusters):
        main = cseq()
        n_seqs = reader.varint()
        clusters.append(Cluster(main, [cseq() for _ in range(n_seqs)]))
    if not reader.exhausted:
        raise ValueError("trailing bytes after cluster set")
    return clusters


def read_clusters(path: str) -> ClusterSet:
    """Load a clusters.out file, auto-detecting old/new cseq layout."""
    with open(path, "rb") as fh:
        data = fh.read()
    errors = []
    for with_gene_id in (True, False):
        try:
            return _parse(data, with_gene_id)
        except (EOFError, ValueError) as exc:  # wrong layout -> misaligned stream
            errors.append(exc)
    raise ValueError(f"could not parse {path} as a RATTLE cluster set: {errors}")


def write_clusters(clusters: ClusterSet, path: str) -> None:
    """Write the current reference layout (seq_id, rev, gene_id)."""
    buf = io.BytesIO()
    _write_varint(buf, len(clusters))

    def put(cs: CSeq) -> None:
        _write_varint(buf, _zigzag_encode(cs.seq_id))
        buf.write(b"\x01" if cs.rev else b"\x00")
        _write_varint(buf, _zigzag_encode(cs.gene_id))

    for cluster in clusters:
        put(cluster.main_seq)
        _write_varint(buf, len(cluster.seqs))
        for cs in cluster.seqs:
            put(cs)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
