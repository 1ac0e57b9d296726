"""Evidence of Byzantine behavior (reference: types/evidence.go) — the
duplicate-vote half that the port verifies (two conflicting votes from
one validator at the same height, round and type), its wire encoding
and hash, and a block's EvidenceData. Verification lives in
evidence/verify.py and uses the BatchVerifier. Light-client-attack evidence
lives in light/types.py and decodes here. Both kinds give their ABCI
form (to_abci: abci/types.py Misbehavior entries)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from ..encoding.proto import Reader, Writer
from .block import BlockID
from .vote import Vote


def block_key(block_id: BlockID | None) -> bytes:
    """A vote's block id as an ordering key (nil sorts first)."""
    return b"" if block_id is None else block_id.key()


class Evidence:
    """Structural base: subclasses implement hash/validate/wire."""

    def hash(self) -> bytes:
        raise NotImplementedError

    def height(self) -> int:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        raise NotImplementedError


@dataclass
class DuplicateVoteEvidence(Evidence):
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

    def hash(self) -> bytes:
        return tmhash.sum256(self.to_bytes())

    def to_abci(self) -> list:
        """BeginBlock byzantine_validators entries (reference:
        types/evidence.py:72; Go types/evidence.go ABCI())."""
        from ..abci.types import Misbehavior

        return [Misbehavior(
            type="DUPLICATE_VOTE",
            validator_address=self.vote_a.validator_address,
            validator_power=self.validator_power,
            height=self.vote_a.height,
            time=self.timestamp,
            total_voting_power=self.total_voting_power,
        )]

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("missing votes")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if block_key(self.vote_a.block_id) >= block_key(self.vote_b.block_id):
            raise ValueError("duplicate votes in wrong order or identical")

    def to_proto(self) -> Writer:
        w = Writer()
        w.message(1, self.vote_a.to_proto())
        w.message(2, self.vote_b.to_proto())
        w.varint(3, self.total_voting_power)
        w.varint(4, self.validator_power)
        w.varint(5, self.timestamp)
        return w

    def to_bytes(self) -> bytes:
        return Writer().message(1, self.to_proto()).finish()

    @classmethod
    def _from_inner(cls, data: bytes) -> "DuplicateVoteEvidence":
        r = Reader(data)
        va = vb = None
        tvp = vp = ts = 0
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                va = Vote.from_bytes(r.bytes())
            elif f == 2:
                vb = Vote.from_bytes(r.bytes())
            elif f == 3:
                tvp = r.varint()
            elif f == 4:
                vp = r.varint()
            elif f == 5:
                ts = r.varint()
            else:
                r.skip(wt)
        if va is None or vb is None:
            raise ValueError("duplicate-vote evidence missing votes")
        return cls(va, vb, tvp, vp, ts)


def evidence_from_bytes(data: bytes) -> Evidence:
    r = Reader(data)
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            return DuplicateVoteEvidence._from_inner(r.bytes())
        if f == 2:
            from ..light.types import LightClientAttackEvidence

            return LightClientAttackEvidence._from_inner(r.bytes())
        r.skip(wt)
    raise ValueError("unknown evidence encoding")


@dataclass
class EvidenceData:
    evidence: list[Evidence] = field(default_factory=list)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices([e.hash() for e in self.evidence])

    def to_proto(self) -> Writer | None:
        if not self.evidence:
            return None
        w = Writer()
        for e in self.evidence:
            w.bytes(1, e.to_bytes(), skip_empty=False)
        return w

    @classmethod
    def from_bytes(cls, data: bytes) -> "EvidenceData":
        r = Reader(data)
        out = []
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                out.append(evidence_from_bytes(r.bytes()))
            else:
                r.skip(wt)
        return cls(out)
