"""Blocks, headers, commits, part sets (reference: types/block.go,
part_set.go).

Hashing follows the reference's scheme: Header.hash() is the merkle
root of the deterministically-encoded header fields
(types/block.go:408-430); a block's wire form is split into fixed-size
parts whose merkle root (PartSetHeader) is what validators vote on.
Fast sync verifies block h with block h+1's LastCommit over
BlockID(h's hash, its part set's header) (blockchain/verify_ahead.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from ..encoding.proto import Reader, Writer
from . import canonical

BLOCK_PART_SIZE = 65536
MAX_SIGNATURE_SIZE = 96  # fits ed25519 (64) and sr25519 (64); headroom
MAX_HEADER_BYTES = 626


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

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header is not None
            and self.part_set_header.total > 0
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


def zero_block_id_bytes() -> bytes:
    """Marshal of a ZERO tmproto.BlockID — not empty: the non-nullable
    part_set_header still emits (reference gogo semantics; the
    Header.hash leaf for a genesis last_block_id depends on this)."""
    return Writer().message(2, Writer()).finish()


def read_block_id(data: bytes) -> BlockID:
    r = Reader(data)
    h, psh = b"", None
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            h = r.bytes()
        elif f == 2:
            rr = Reader(r.bytes())
            total, ph = 0, b""
            while not rr.at_end():
                ff, wwt = rr.field()
                if ff == 1:
                    total = rr.varint()
                elif ff == 2:
                    ph = rr.bytes()
                else:
                    rr.skip(wwt)
            psh = PartSetHeader(total, ph)
        else:
            r.skip(wt)
    return BlockID(h, psh)


def read_timestamp(data: bytes) -> int:
    r = Reader(data)
    secs = nanos = 0
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            secs = r.varint()
        elif f == 2:
            nanos = r.varint()
        else:
            r.skip(wt)
    return secs * 1_000_000_000 + nanos


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

    @classmethod
    def from_reader(cls, data: bytes) -> "CommitSig":
        r = Reader(data)
        cs = cls(BlockIDFlag.ABSENT)
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                cs.block_id_flag = r.varint()
            elif f == 2:
                cs.validator_address = r.bytes()
            elif f == 3:
                cs.timestamp = read_timestamp(r.bytes())
            elif f == 4:
                cs.signature = r.bytes()
            else:
                r.skip(wt)
        return cs


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

    @classmethod
    def from_bytes(cls, data: bytes) -> "Commit":
        r = Reader(data)
        height = round_ = 0
        bid = NIL_BLOCK_ID
        sigs: list[CommitSig] = []
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                round_ = r.varint()
            elif f == 3:
                bid = read_block_id(r.bytes())
            elif f == 4:
                sigs.append(CommitSig.from_reader(r.bytes()))
            else:
                r.skip(wt)
        return cls(height, round_, bid, sigs)


@dataclass
class Header:
    """Block header (reference: types/block.go:334)."""

    version_block: int
    version_app: int
    chain_id: str
    height: int
    time: int  # ns
    last_block_id: BlockID
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes
    _hash: bytes | None = field(default=None, repr=False, compare=False, init=False)

    def hash(self) -> bytes:
        """Merkle root of the deterministically-encoded fields
        (reference: types/block.go:408)."""
        if not self.validators_hash:
            return b""
        if self._hash is None:
            vw = Writer()
            vw.varint(1, self.version_block)
            vw.varint(2, self.version_app)

            def bv(b: bytes) -> bytes:
                # cdcEncode wraps byte fields in a BytesValue message
                # (field 1, length-delimited) before hashing
                return Writer().bytes(1, b).finish()

            lbid = block_id_writer(self.last_block_id)
            fields = [
                vw.finish(),
                Writer().string(1, self.chain_id).finish(),
                Writer().varint(1, self.height).finish(),
                (canonical.timestamp_writer(self.time) or Writer()).finish(),
                lbid.finish() if lbid is not None else zero_block_id_bytes(),
                bv(self.last_commit_hash),
                bv(self.data_hash),
                bv(self.validators_hash),
                bv(self.next_validators_hash),
                bv(self.consensus_hash),
                bv(self.app_hash),
                bv(self.last_results_hash),
                bv(self.evidence_hash),
                bv(self.proposer_address),
            ]
            self._hash = merkle.hash_from_byte_slices(fields)
        return self._hash

    def validate_basic(self) -> None:
        if not self.chain_id or len(self.chain_id) > 50:
            raise ValueError("bad chain id")
        if self.height < 0:
            raise ValueError("negative height")
        if self.last_block_id is not None:  # None = genesis (Go zero value)
            self.last_block_id.validate_basic()
        for name in (
            "last_commit_hash", "data_hash", "validators_hash",
            "next_validators_hash", "consensus_hash", "last_results_hash",
            "evidence_hash",
        ):
            h = getattr(self, name)
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"bad {name} size")
        if len(self.proposer_address) != 20:
            raise ValueError("bad proposer address size")

    def to_proto(self) -> Writer:
        w = Writer()
        vw = Writer()
        vw.varint(1, self.version_block)
        vw.varint(2, self.version_app)
        w.message(1, vw)
        w.string(2, self.chain_id)
        w.varint(3, self.height)
        w.message(4, canonical.timestamp_writer(self.time))
        w.message(5, block_id_writer(self.last_block_id))
        w.bytes(6, self.last_commit_hash)
        w.bytes(7, self.data_hash)
        w.bytes(8, self.validators_hash)
        w.bytes(9, self.next_validators_hash)
        w.bytes(10, self.consensus_hash)
        w.bytes(11, self.app_hash)
        w.bytes(12, self.last_results_hash)
        w.bytes(13, self.evidence_hash)
        w.bytes(14, self.proposer_address)
        return w

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        r = Reader(data)
        kw = dict(
            version_block=0, version_app=0, chain_id="", height=0, time=0,
            last_block_id=NIL_BLOCK_ID, last_commit_hash=b"", data_hash=b"",
            validators_hash=b"", next_validators_hash=b"", consensus_hash=b"",
            app_hash=b"", last_results_hash=b"", evidence_hash=b"",
            proposer_address=b"",
        )
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                rr = Reader(r.bytes())
                while not rr.at_end():
                    ff, wwt = rr.field()
                    if ff == 1:
                        kw["version_block"] = rr.varint()
                    elif ff == 2:
                        kw["version_app"] = rr.varint()
                    else:
                        rr.skip(wwt)
            elif f == 2:
                kw["chain_id"] = r.string()
            elif f == 3:
                kw["height"] = r.varint()
            elif f == 4:
                kw["time"] = read_timestamp(r.bytes())
            elif f == 5:
                kw["last_block_id"] = read_block_id(r.bytes())
            elif 6 <= f <= 14:
                names = [
                    "last_commit_hash", "data_hash", "validators_hash",
                    "next_validators_hash", "consensus_hash", "app_hash",
                    "last_results_hash", "evidence_hash", "proposer_address",
                ]
                kw[names[f - 6]] = r.bytes()
            else:
                r.skip(wt)
        return cls(**kw)


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(self.txs)


@dataclass
class Block:
    header: Header
    data: Data
    evidence: "EvidenceData"
    last_commit: Commit | None

    def hash(self) -> bytes:
        return self.header.hash()

    def validate_basic(self) -> None:
        self.header.validate_basic()
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("nil LastCommit")
            self.last_commit.validate_basic()
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
        if self.header.evidence_hash != self.evidence.hash():
            raise ValueError("wrong EvidenceHash")

    def make_part_set(self, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        return PartSet.from_data(self.to_bytes(), part_size)

    def block_id(self, part_size: int = BLOCK_PART_SIZE) -> BlockID:
        ps = self.make_part_set(part_size)
        return BlockID(self.hash(), ps.header())

    def to_proto(self) -> Writer:
        w = Writer()
        w.message(1, self.header.to_proto())
        if self.data.txs:
            dw = Writer()
            for tx in self.data.txs:
                dw.bytes(1, tx, skip_empty=False)
            w.message(2, dw)
        ev_w = self.evidence.to_proto()
        if ev_w is not None:
            w.message(3, ev_w)
        if self.last_commit is not None:
            w.message(4, self.last_commit.to_proto())
        return w

    def to_bytes(self) -> bytes:
        return self.to_proto().finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Block":
        from .evidence import EvidenceData

        r = Reader(data)
        header = None
        d = Data()
        ev = EvidenceData()
        lc = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                header = Header.from_bytes(r.bytes())
            elif f == 2:
                rr = Reader(r.bytes())
                while not rr.at_end():
                    ff, wwt = rr.field()
                    if ff == 1:
                        d.txs.append(rr.bytes())
                    else:
                        rr.skip(wwt)
            elif f == 3:
                ev = EvidenceData.from_bytes(r.bytes())
            elif f == 4:
                lc = Commit.from_bytes(r.bytes())
            else:
                r.skip(wt)
        if header is None:
            raise ValueError("block missing header")
        return cls(header, d, ev, lc)


# --- Part sets (reference: types/part_set.go) --------------------------------


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative part index")
        if self.proof.index != self.index:
            raise ValueError("part proof index mismatch")

    def to_proto(self) -> "Writer":
        w = Writer()
        w.varint(1, self.index, skip_zero=False)
        w.bytes(2, self.bytes_, skip_empty=False)
        pw = Writer()
        pw.varint(1, self.proof.total)
        pw.varint(2, self.proof.index, skip_zero=False)
        pw.bytes(3, self.proof.leaf_hash)
        for a in self.proof.aunts:
            pw.bytes(4, a, skip_empty=False)
        w.message(3, pw)
        return w

    def to_bytes(self) -> bytes:
        return self.to_proto().finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Part":
        r = Reader(data)
        index, bytes_ = 0, b""
        proof = merkle.Proof(0, 0, b"", [])
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                index = r.varint()
            elif f == 2:
                bytes_ = r.bytes()
            elif f == 3:
                rr = Reader(r.bytes())
                total = pidx = 0
                lh: bytes = b""
                aunts: list[bytes] = []
                while not rr.at_end():
                    ff, wwt = rr.field()
                    if ff == 1:
                        total = rr.varint()
                    elif ff == 2:
                        pidx = rr.varint()
                    elif ff == 3:
                        lh = rr.bytes()
                    elif ff == 4:
                        aunts.append(rr.bytes())
                    else:
                        rr.skip(wwt)
                proof = merkle.Proof(total, pidx, lh, aunts)
            else:
                r.skip(wt)
        return cls(index, bytes_, proof)


class PartSet:
    """A block's wire bytes split into merkle-proven parts."""

    def __init__(self, total: int, hash_: bytes):
        from ..libs.bits import BitArray

        self.total = total
        self.hash = hash_
        self.parts: list[Part | None] = [None] * total
        self.parts_bitarray = BitArray(total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)]
        if not chunks:
            chunks = [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(len(chunks), root)
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps.parts[i] = Part(i, chunk, proof)
            ps.parts_bitarray.set(i, True)
        ps.count = len(chunks)
        ps.byte_size = len(data)
        return ps

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self.hash)

    def has_header(self, h: PartSetHeader) -> bool:
        return self.total == h.total and self.hash == h.hash

    def add_part(self, part: Part) -> bool:
        """Returns True if added; raises on invalid proof."""
        if part.index >= self.total:
            raise ValueError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        part.validate_basic()
        if not part.proof.verify(self.hash, part.bytes_):
            raise ValueError("invalid part proof")
        self.parts[part.index] = part
        self.parts_bitarray.set(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, i: int) -> Part | None:
        return self.parts[i]

    def is_complete(self) -> bool:
        return self.count == self.total

    def assemble(self) -> bytes:
        assert self.is_complete()
        return b"".join(p.bytes_ for p in self.parts)  # type: ignore[union-attr]
