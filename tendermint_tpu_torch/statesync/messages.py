"""State-sync wire messages, channels 0x60/0x61 (reference:
statesync/messages.py; Go statesync/messages.go). The bytes equal the
reference's."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding.proto import Reader, Writer

MAX_MSG_SIZE = 16_777_216 + 1024  # 16MB chunks (reference chunks.go)


@dataclass
class SnapshotsRequestMessage:
    pass


@dataclass
class SnapshotsResponseMessage:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


@dataclass
class ChunkRequestMessage:
    height: int
    format: int
    index: int


@dataclass
class ChunkResponseMessage:
    height: int
    format: int
    index: int
    chunk: bytes = b""
    missing: bool = False


_TAG = {
    SnapshotsRequestMessage: 1,
    SnapshotsResponseMessage: 2,
    ChunkRequestMessage: 3,
    ChunkResponseMessage: 4,
}
_BY_TAG = {v: k for k, v in _TAG.items()}


def encode_ss_msg(msg) -> bytes:
    w = Writer()
    if isinstance(msg, SnapshotsResponseMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.format)
        w.varint(3, msg.chunks)
        w.bytes(4, msg.hash)
        w.bytes(5, msg.metadata)
    elif isinstance(msg, ChunkRequestMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.format)
        w.varint(3, msg.index, skip_zero=False)
    elif isinstance(msg, ChunkResponseMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.format)
        w.varint(3, msg.index, skip_zero=False)
        w.bytes(4, msg.chunk)
        w.bool(5, msg.missing)
    elif not isinstance(msg, SnapshotsRequestMessage):
        raise ValueError(f"unknown statesync message {type(msg)}")
    return bytes([_TAG[type(msg)]]) + w.finish()


def decode_ss_msg(data: bytes):
    if not data:
        raise ValueError("empty statesync message")
    if len(data) > MAX_MSG_SIZE:
        raise ValueError("statesync message exceeds max size")
    cls = _BY_TAG.get(data[0])
    if cls is None:
        raise ValueError(f"unknown statesync message tag {data[0]}")
    r = Reader(data[1:])
    if cls is SnapshotsRequestMessage:
        return cls()
    fields: dict[int, object] = {}
    while not r.at_end():
        f, wt = r.field()
        if wt == 0:
            fields[f] = r.varint()
        elif wt == 2:
            fields[f] = r.bytes()
        else:
            r.skip(wt)
    if cls is SnapshotsResponseMessage:
        msg = cls(height=int(fields.get(1, 0)), format=int(fields.get(2, 0)),
                  chunks=int(fields.get(3, 0)), hash=fields.get(4, b""),
                  metadata=fields.get(5, b""))
        if msg.height < 1 or msg.chunks < 1 or not msg.hash:
            raise ValueError("invalid snapshots response")
        return msg
    if cls is ChunkRequestMessage:
        msg = cls(height=int(fields.get(1, 0)), format=int(fields.get(2, 0)),
                  index=int(fields.get(3, 0)))
        if msg.height < 1 or msg.index < 0:
            raise ValueError("invalid chunk request")
        return msg
    msg = ChunkResponseMessage(
        height=int(fields.get(1, 0)), format=int(fields.get(2, 0)),
        index=int(fields.get(3, 0)), chunk=fields.get(4, b""),
        missing=bool(fields.get(5, 0)))
    if msg.height < 1 or msg.index < 0:
        raise ValueError("invalid chunk response")
    return msg
