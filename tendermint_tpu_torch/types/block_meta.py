"""BlockMeta — header + sizing info stored per height (reference:
types/block_meta.py; Go types/block_meta.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding.proto import Reader, Writer
from .block import Block, BlockID, Header, block_id_writer, read_block_id


@dataclass
class BlockMeta:
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    @classmethod
    def from_block(cls, block: Block,
                   block_id: BlockID | None = None) -> "BlockMeta":
        data = block.to_bytes()
        bid = block_id or block.block_id()
        return cls(bid, len(data), block.header, len(block.data.txs))

    def to_bytes(self) -> bytes:
        w = Writer()
        w.message(1, block_id_writer(self.block_id))
        w.varint(2, self.block_size)
        w.message(3, self.header.to_proto())
        w.varint(4, self.num_txs)
        return w.finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlockMeta":
        r = Reader(data)
        bid = BlockID(b"", None)
        size = num_txs = 0
        header = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                bid = read_block_id(r.bytes())
            elif f == 2:
                size = r.varint()
            elif f == 3:
                header = Header.from_bytes(r.bytes())
            elif f == 4:
                num_txs = r.varint()
            else:
                r.skip(wt)
        assert header is not None, "block meta missing header"
        return cls(bid, size, header, num_txs)
