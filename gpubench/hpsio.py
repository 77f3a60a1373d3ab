# Frozen from rattle_tpu_torch/io/hpsio.py (write_clusters, read_clusters): the clusters.out format of RATTLE's hps serialisation.
"""``clusters.out``: a varint count of clusters, each its representative
then a varint count of members, each member (seq_id, rev, gene_id) as a
zigzag varint, one byte and a zigzag varint (the current layout; older
builds wrote no gene_id, which ``read`` also takes)."""

from __future__ import annotations

import io
from typing import List, Tuple

Member = Tuple[int, bool, int]
Clusters = List[Tuple[Member, List[Member]]]


def _varint(buf: io.BytesIO, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            buf.write(bytes([byte | 0x80]))
        else:
            buf.write(bytes([byte]))
            return


def _zigzag(value: int) -> int:
    return ((value << 1) ^ (value >> 63)) & ((1 << 64) - 1)


def dumps(clusters: Clusters) -> bytes:
    buf = io.BytesIO()
    _varint(buf, len(clusters))

    def put(m: Member) -> None:
        _varint(buf, _zigzag(m[0]))
        buf.write(b"\x01" if m[1] else b"\x00")
        _varint(buf, _zigzag(m[2]))

    for main, members in clusters:
        put(main)
        _varint(buf, len(members))
        for m in members:
            put(m)
    return buf.getvalue()


def _parse(data: bytes, with_gene_id: bool) -> Clusters:
    pos = 0

    def varint() -> int:
        nonlocal pos
        out = shift = 0
        while True:
            if pos >= len(data):
                raise EOFError("truncated varint")
            byte = data[pos]
            pos += 1
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7

    def signed() -> int:
        v = varint()
        return (v >> 1) ^ -(v & 1)

    def member() -> Member:
        nonlocal pos
        sid = signed()
        if pos >= len(data):
            raise EOFError("truncated bool")
        rev = data[pos] != 0
        pos += 1
        return (sid, rev, signed() if with_gene_id else -1)

    out: Clusters = []
    for _ in range(varint()):
        main = member()
        out.append((main, [member() for _ in range(varint())]))
    if pos != len(data):
        raise ValueError("trailing bytes after cluster set")
    return out


def loads(data: bytes) -> Clusters:
    errors = []
    for with_gene_id in (True, False):
        try:
            return _parse(data, with_gene_id)
        except (EOFError, ValueError) as exc:
            errors.append(exc)
    raise ValueError(f"not a RATTLE cluster set: {errors}")
