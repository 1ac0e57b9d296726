"""Vote types (reference: types/vote.go) — only what a commit's sign
bytes, validation and the speculation plane need in this slice of the
port."""

from __future__ import annotations

import enum
from dataclasses import dataclass

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
