"""Block IDs and commits (reference: types/block.go).

The slice of the reference's block types that commit verification
needs: BlockID/PartSetHeader, CommitSig, Commit and the per-slot vote
sign bytes. Header, Block and PartSet come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from ..encoding.proto import Writer
from . import canonical

MAX_SIGNATURE_SIZE = 96  # fits ed25519 (64) and sr25519 (64); headroom


class BlockIDFlag:
    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int
    hash: bytes

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def validate_basic(self) -> None:
        if not 0 <= self.total < 1 << 32:
            raise ValueError("part set total out of range")
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("bad part set hash size")

    def __repr__(self) -> str:
        return f"PartSetHeader({self.total}, {self.hash.hex()[:12]})"


@dataclass(frozen=True)
class BlockID:
    hash: bytes
    part_set_header: PartSetHeader | None = None

    def is_nil(self) -> bool:
        return not self.hash

    def is_zero(self) -> bool:
        """Reference BlockID.IsZero (types/block.go): empty hash AND
        zero part_set_header. This — not is_nil()'s hash-only check —
        is what gates canonical/proto omission: a BlockID carrying a
        part-set header with an empty hash must still encode, or its
        sign bytes diverge from the reference's."""
        return not self.hash and (
            self.part_set_header is None or self.part_set_header.is_zero()
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("bad block hash size")
        if self.part_set_header is not None:
            self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Unambiguous map key: length-framed so no two distinct BlockIDs
        collide (an unframed concat would let a crafted 68-byte 'hash'
        impersonate hash+part_set_header). 4-byte frame: peer-supplied
        hashes can be oversized and must not crash the keyer."""
        psh = self.part_set_header
        out = len(self.hash).to_bytes(4, "big") + self.hash
        if psh is not None:
            if not 0 <= psh.total < 1 << 32:
                raise ValueError("part set total out of range")
            out += b"\x01" + psh.total.to_bytes(4, "big") + psh.hash
        return out

    def __repr__(self) -> str:
        return f"BlockID({self.hash.hex()[:12]})" if self.hash else "BlockID(nil)"


NIL_BLOCK_ID = BlockID(b"", None)


def block_id_writer(bid: BlockID | None) -> Writer | None:
    """tmproto.BlockID. part_set_header is gogoproto nullable=false in
    the reference (types.proto:98-99), so whenever a BlockID message is
    marshaled at all, field 2 is present — even as an empty submessage.
    Cross-validated against the reference MBT corpus header hashes
    (light/mbt_ref.py).

    Only the repo's None-psh nil sentinel omits here: an EXPLICIT zero
    part_set_header (what decoding reference-marshaled nil-vote bytes
    produces) still emits `field {psh: {}}` byte-identically with the
    gogo marshaler. Full IsZero() omission applies to CANONICAL sign
    bytes only (canonical.canonical_block_id_writer), where the
    reference's CanonicalizeBlockID nils out zero ids — this writer's
    behavior is deliberately UNCHANGED by that fix."""
    if bid is None or (bid.is_nil() and bid.part_set_header is None):
        return None
    w = Writer()
    w.bytes(1, bid.hash)
    pw = Writer()
    psh = bid.part_set_header
    if psh is not None:
        pw.varint(1, psh.total)
        pw.bytes(2, psh.hash)
    w.message(2, pw)
    return w


@dataclass
class CommitSig:
    """One validator's slot in a commit (reference: types/block.go:603)."""

    block_id_flag: int
    validator_address: bytes = b""
    timestamp: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(BlockIDFlag.ABSENT)

    def is_absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BlockIDFlag.ABSENT, BlockIDFlag.COMMIT, BlockIDFlag.NIL,
        ):
            raise ValueError("unknown BlockIDFlag")
        if self.is_absent():
            if self.validator_address or self.signature or self.timestamp:
                raise ValueError("absent CommitSig must be empty")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("bad validator address size")
            if not self.signature:
                raise ValueError("missing signature")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("signature too big")

    def block_id_for(self, commit_block_id: BlockID) -> BlockID:
        if self.for_block():
            return commit_block_id
        return NIL_BLOCK_ID

    def to_proto(self) -> Writer:
        w = Writer()
        w.varint(1, self.block_id_flag)
        w.bytes(2, self.validator_address)
        w.message(3, canonical.timestamp_writer(self.timestamp))
        w.bytes(4, self.signature)
        return w

@dataclass
class Commit:
    """+2/3 precommits for a block (reference: types/block.go:553)."""

    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig]
    _hash: bytes | None = field(default=None, repr=False, compare=False, init=False)

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            from .vote import MAX_VOTES_COUNT

            if len(self.signatures) > MAX_VOTES_COUNT:
                raise ValueError("too many signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [cs.to_proto().finish() for cs in self.signatures]
            )
        return self._hash

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Sign bytes for the precommit in slot idx (reference:
        types/block.go Commit.VoteSignBytes)."""
        cs = self.signatures[idx]
        from .vote import VoteType

        return canonical.vote_sign_bytes(
            chain_id,
            int(VoteType.PRECOMMIT),
            self.height,
            self.round,
            cs.block_id_for(self.block_id),
            cs.timestamp,
        )

    def size(self) -> int:
        return len(self.signatures)

    def to_proto(self) -> Writer:
        w = Writer()
        w.varint(1, self.height)
        w.varint(2, self.round)
        w.message(3, block_id_writer(self.block_id))
        for cs in self.signatures:
            w.message(4, cs.to_proto())
        return w

    def to_bytes(self) -> bytes:
        return self.to_proto().finish()
