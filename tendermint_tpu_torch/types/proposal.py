"""Block proposals (reference: types/proposal.py; Go types/proposal.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding.proto import Reader, Writer
from . import canonical
from .block import BlockID, block_id_writer, read_block_id, read_timestamp


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int  # -1 if no proof-of-lock
    block_id: BlockID
    timestamp: int = 0
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round,
            self.block_id, self.timestamp,
        )

    def validate_basic(self) -> None:
        from .block import MAX_SIGNATURE_SIZE

        if self.height <= 0:
            raise ValueError("proposal height must be positive")
        if self.round < 0:
            raise ValueError("negative round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("bad POL round")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("proposal BlockID must be complete")
        if not self.signature:
            raise ValueError("missing signature")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature too big")

    def to_proto(self) -> Writer:
        w = Writer()
        w.varint(1, 32)  # type PROPOSAL
        w.varint(2, self.height)
        w.varint(3, self.round)
        # pol_round encoded +1 so -1 is the (skipped) zero value
        w.varint(4, self.pol_round + 1)
        w.message(5, block_id_writer(self.block_id))
        w.message(6, canonical.timestamp_writer(self.timestamp))
        w.bytes(7, self.signature)
        return w

    def to_bytes(self) -> bytes:
        return self.to_proto().finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proposal":
        r = Reader(data)
        kw = dict(height=0, round=0, pol_round=-1, block_id=None,
                  timestamp=0, signature=b"")
        while not r.at_end():
            f, wt = r.field()
            if f == 2:
                kw["height"] = r.varint()
            elif f == 3:
                kw["round"] = r.varint()
            elif f == 4:
                kw["pol_round"] = r.varint() - 1
            elif f == 5:
                kw["block_id"] = read_block_id(r.bytes())
            elif f == 6:
                kw["timestamp"] = read_timestamp(r.bytes())
            elif f == 7:
                kw["signature"] = r.bytes()
            else:
                r.skip(wt)
        if kw["block_id"] is None:
            raise ValueError("proposal missing block_id")
        return cls(**kw)
