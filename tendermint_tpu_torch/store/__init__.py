"""BlockStore — blocks persisted as meta + parts + commits (reference:
store/__init__.py; Go store/store.go:33).

Key layout mirrors the reference: H:<height> meta, P:<height>:<part>
part bytes, C:<height> last commit, SC:<height> seen commit, BH:<hash>
the height of a hash, and a blockStore state record tracking (base,
height) for pruning."""

from __future__ import annotations

import json
import struct

from ..libs import failpoints
from ..libs.db import DB
from ..types.block import Block, BlockID, Commit, Part, PartSet
from ..types.block_meta import BlockMeta

_STORE_KEY = b"blockStore"


def _h(height: int) -> bytes:
    return struct.pack(">Q", height)


class BlockStore:
    def __init__(self, db: DB):
        self.db = db
        st = db.get(_STORE_KEY)
        if st is not None:
            d = json.loads(st)
            self.base, self.height = d["base"], d["height"]
        else:
            self.base = self.height = 0

    def size(self) -> int:
        return self.height - self.base + 1 if self.height else 0

    # -- reads --

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self.db.get(b"H:" + _h(height))
        return BlockMeta.from_bytes(raw) if raw is not None else None

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            raw = self.db.get(b"P:" + _h(height) + struct.pack(">I", i))
            if raw is None:
                return None
            parts.append(Part.from_bytes(raw).bytes_)
        return Block.from_bytes(b"".join(parts))

    def load_block_by_hash(self, hash_: bytes) -> Block | None:
        raw = self.db.get(b"BH:" + hash_)
        if raw is None:
            return None
        return self.load_block(struct.unpack(">Q", raw)[0])

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self.db.get(b"P:" + _h(height) + struct.pack(">I", index))
        if raw is None:
            return None
        return Part.from_bytes(raw)

    def load_block_commit(self, height: int) -> Commit | None:
        """The commit for `height` as included in block height+1."""
        raw = self.db.get(b"C:" + _h(height))
        return Commit.from_bytes(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self.db.get(b"SC:" + _h(height))
        return Commit.from_bytes(raw) if raw is not None else None

    # -- writes --

    def save_block(self, block: Block, parts: PartSet,
                   seen_commit: Commit) -> None:
        height = block.header.height
        if self.height and height != self.height + 1:
            raise ValueError(
                f"cannot save block {height}, expected {self.height + 1}"
            )
        if not parts.is_complete():
            raise ValueError("cannot save incomplete part set")
        bid = BlockID(block.hash(), parts.header())
        meta = BlockMeta(bid, parts.byte_size, block.header,
                         len(block.data.txs))
        ops: list[tuple[bytes, bytes | None]] = [
            (b"H:" + _h(height), meta.to_bytes()),
            (b"BH:" + block.hash(), struct.pack(">Q", height)),
            (b"SC:" + _h(height), seen_commit.to_proto().finish()),
        ]
        for i in range(parts.total):
            part = parts.get_part(i)
            assert part is not None
            ops.append((b"P:" + _h(height) + struct.pack(">I", i),
                        part.to_bytes()))
        if block.last_commit is not None:
            ops.append(
                (b"C:" + _h(height - 1), block.last_commit.to_proto().finish())
            )
        new_base = self.base or height
        ops.append((_STORE_KEY, self._state_bytes(new_base, height)))
        # a failed write must leave the previous height intact (the
        # batch is atomic at the DB level), and the in-memory (base,
        # height) moves only after the batch lands
        failpoints.hit("store.save_block")
        self.db.write_batch(ops)
        self.base = new_base
        self.height = height

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self.db.set(b"SC:" + _h(height), commit.to_proto().finish())

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height (Go reference store.go:248)."""
        if retain_height <= self.base:
            return 0
        if retain_height > self.height:
            raise ValueError("cannot prune beyond latest height")
        pruned = 0
        ops: list[tuple[bytes, bytes | None]] = []
        for height in range(self.base, retain_height):
            meta = self.load_block_meta(height)
            if meta is None:
                continue
            ops.append((b"H:" + _h(height), None))
            ops.append((b"BH:" + meta.block_id.hash, None))
            ops.append((b"C:" + _h(height), None))
            ops.append((b"SC:" + _h(height), None))
            for i in range(meta.block_id.part_set_header.total):
                ops.append((b"P:" + _h(height) + struct.pack(">I", i), None))
            pruned += 1
        ops.append((_STORE_KEY, self._state_bytes(retain_height,
                                                  self.height)))
        self.db.write_batch(ops)
        self.base = retain_height
        return pruned

    def _state_bytes(self, base: int, height: int) -> bytes:
        return json.dumps({"base": base, "height": height}).encode()
