"""Evidence of Byzantine behavior (reference: types/evidence.go) — the
duplicate-vote half that the port verifies: two conflicting votes from
one validator at the same height, round and type. Verification lives
in evidence/verify.py and uses the BatchVerifier. Its wire encoding,
hash, ABCI form and light-client-attack evidence come with later
slices of the port."""

from __future__ import annotations

from dataclasses import dataclass

from .block import BlockID
from .vote import Vote


def block_key(block_id: BlockID | None) -> bytes:
    """A vote's block id as an ordering key (nil sorts first)."""
    return b"" if block_id is None else block_id.key()


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: int = 0

    @classmethod
    def from_votes(cls, vote1: Vote, vote2: Vote, block_time: int,
                   val_set) -> "DuplicateVoteEvidence":
        """Order votes lexicographically by BlockID key (deterministic),
        record powers (reference: types/evidence.go:36)."""
        if vote1 is None or vote2 is None or val_set is None:
            raise ValueError("missing vote or valset")
        if block_key(vote1.block_id) < block_key(vote2.block_id):
            a, b = vote1, vote2
        else:
            a, b = vote2, vote1
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise ValueError("validator not in set")
        return cls(
            vote_a=a,
            vote_b=b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def height(self) -> int:
        return self.vote_a.height

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("missing votes")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if block_key(self.vote_a.block_id) >= block_key(self.vote_b.block_id):
            raise ValueError("duplicate votes in wrong order or identical")
