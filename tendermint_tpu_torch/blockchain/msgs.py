"""Fast-sync wire messages (reference: blockchain/msgs.go).

Same tag+protobuf framing as the consensus codec; blocks ride their
canonical proto encoding."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding.proto import Reader, Writer
from ..types.block import Block

MAX_MSG_SIZE = 10_485_760 + 1024  # reference bcBlockResponseMessagePrefixSize


@dataclass
class BlockRequestMessage:
    height: int


@dataclass
class BlockResponseMessage:
    block: Block


@dataclass
class NoBlockResponseMessage:
    height: int


@dataclass
class StatusRequestMessage:
    pass


@dataclass
class StatusResponseMessage:
    height: int
    base: int


_TAG = {
    BlockRequestMessage: 1,
    BlockResponseMessage: 2,
    NoBlockResponseMessage: 3,
    StatusRequestMessage: 4,
    StatusResponseMessage: 5,
}
_BY_TAG = {v: k for k, v in _TAG.items()}


def encode_bc_msg(msg) -> bytes:
    w = Writer()
    if isinstance(msg, (BlockRequestMessage, NoBlockResponseMessage)):
        w.varint(1, msg.height)
    elif isinstance(msg, BlockResponseMessage):
        w.bytes(1, msg.block.to_bytes())
    elif isinstance(msg, StatusResponseMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.base)
    elif isinstance(msg, StatusRequestMessage):
        pass
    else:
        raise ValueError(f"unknown blockchain message {type(msg)}")
    return bytes([_TAG[type(msg)]]) + w.finish()


def decode_bc_msg(data: bytes):
    if not data:
        raise ValueError("empty blockchain message")
    if len(data) > MAX_MSG_SIZE:
        raise ValueError("blockchain message exceeds max size")
    cls = _BY_TAG.get(data[0])
    if cls is None:
        raise ValueError(f"unknown blockchain message tag {data[0]}")
    r = Reader(data[1:])
    if cls is StatusRequestMessage:
        return cls()
    if cls is BlockResponseMessage:
        block = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                block = Block.from_bytes(r.bytes())
            else:
                r.skip(wt)
        if block is None:
            raise ValueError("block response without block")
        return cls(block)
    if cls in (BlockRequestMessage, NoBlockResponseMessage):
        height = 0
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            else:
                r.skip(wt)
        if height < 1:
            raise ValueError("invalid height")
        return cls(height)
    # StatusResponseMessage
    height = base = 0
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            height = r.varint()
        elif f == 2:
            base = r.varint()
        else:
            r.skip(wt)
    if height < 0 or base < 0 or base > height:
        raise ValueError("invalid status response")
    return cls(height, base)
