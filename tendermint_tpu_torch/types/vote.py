"""Vote types (reference: types/vote.go): sign bytes, validation, the
single-signature host verify and the wire encoding that a commit, the
speculation plane and duplicate-vote evidence need. Vote sets come with
a later slice of the port."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..encoding.proto import Reader, Writer
from . import canonical


class VoteType(enum.IntEnum):
    PREVOTE = 1
    PRECOMMIT = 2

    @classmethod
    def is_valid(cls, v: int) -> bool:
        return v in (cls.PREVOTE, cls.PRECOMMIT)


MAX_VOTES_COUNT = 10000  # DoS bound, reference types/vote_set.go:14-18


@dataclass
class Vote:
    """A signed prevote or precommit for a BlockID (None: a nil vote)."""

    type: VoteType
    height: int
    round: int
    block_id: "BlockID | None"  # None == nil vote
    timestamp: int  # ns since epoch
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id, int(self.type), self.height, self.round,
            self.block_id, self.timestamp,
        )

    def verify(self, chain_id: str, pub_key) -> bool:
        """Synchronous single-sig verify (host path). Batch paths go
        through crypto.batch.BatchVerifier with the same sign bytes."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify_signature(self.sign_bytes(chain_id),
                                        self.signature)

    def is_nil(self) -> bool:
        return self.block_id is None or self.block_id.is_nil()

    def validate_basic(self) -> None:
        from .block import MAX_SIGNATURE_SIZE

        if not VoteType.is_valid(int(self.type)):
            raise ValueError("invalid vote type")
        if self.height <= 0:
            raise ValueError("vote height must be positive")
        if self.round < 0:
            raise ValueError("negative round")
        if self.block_id is not None:
            self.block_id.validate_basic()
        if len(self.validator_address) != 20:
            raise ValueError("bad validator address size")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature:
            raise ValueError("missing signature")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature too big")

    # -- wire --

    def to_proto(self) -> Writer:
        from .block import block_id_writer

        w = Writer()
        w.varint(1, int(self.type))
        w.varint(2, self.height)
        w.varint(3, self.round)
        w.message(4, block_id_writer(self.block_id))
        w.message(5, canonical.timestamp_writer(self.timestamp))
        w.bytes(6, self.validator_address)
        w.varint(7, self.validator_index)
        w.bytes(8, self.signature)
        return w

    def to_bytes(self) -> bytes:
        return self.to_proto().finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Vote":
        from .block import read_block_id, read_timestamp

        r = Reader(data)
        kw = dict(
            type=VoteType.PREVOTE, height=0, round=0, block_id=None,
            timestamp=0, validator_address=b"", validator_index=0,
            signature=b"",
        )
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                kw["type"] = VoteType(r.varint())
            elif f == 2:
                kw["height"] = r.varint()
            elif f == 3:
                kw["round"] = r.varint()
            elif f == 4:
                kw["block_id"] = read_block_id(r.bytes())
            elif f == 5:
                kw["timestamp"] = read_timestamp(r.bytes())
            elif f == 6:
                kw["validator_address"] = r.bytes()
            elif f == 7:
                kw["validator_index"] = r.varint()
            elif f == 8:
                kw["signature"] = r.bytes()
            else:
                r.skip(wt)
        return cls(**kw)
