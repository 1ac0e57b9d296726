"""Validators (reference: types/validator.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import PubKey, pubkey_from_type_and_bytes
from ..encoding.proto import Reader, Writer

# crypto.PublicKey oneof field numbers (reference:
# proto/tendermint/crypto/keys.proto — ed25519=1, secp256k1=2;
# sr25519=3 follows the upstream tendermint v0.35 assignment).
_PK_ONEOF = {"ed25519": 1, "secp256k1": 2, "sr25519": 3}
_PK_ONEOF_REV = {v: k for k, v in _PK_ONEOF.items()}


def pubkey_proto_writer(pk: PubKey) -> Writer:
    w = Writer()
    w.bytes(_PK_ONEOF[pk.type_name], pk.bytes(), skip_empty=False)
    return w


def pubkey_from_proto_bytes(data: bytes) -> PubKey:
    r = Reader(data)
    while not r.at_end():
        f, wt = r.field()
        if f in _PK_ONEOF_REV:
            return pubkey_from_type_and_bytes(_PK_ONEOF_REV[f], r.bytes())
        r.skip(wt)
    raise ValueError("PublicKey proto has no known oneof field")


@dataclass
class Validator:
    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, power, 0)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator missing pubkey")
        if self.voting_power < 0:
            raise ValueError("negative voting power")
        if len(self.address) != 20:
            raise ValueError("bad address size")

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break to the lower address
        (reference: types/validator.go CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("duplicate validator address")

    def bytes_for_hash(self) -> bytes:
        """Deterministic encoding hashed into ValidatorsHash
        (reference: types/validator.go Validator.Bytes =
        SimpleValidator{PublicKey pub_key = 1, int64 voting_power = 2}
        with the crypto.PublicKey oneof of keys.proto). Cross-validated
        against the reference's TLA+ MBT corpus, which carries real
        validators_hash values (light/mbt_ref.py)."""
        w = Writer()
        w.message(1, pubkey_proto_writer(self.pub_key))
        w.varint(2, self.voting_power)
        return w.finish()

    def copy(self) -> "Validator":
        return Validator(
            self.address, self.pub_key, self.voting_power, self.proposer_priority
        )

    def to_proto(self) -> Writer:
        """reference: proto/tendermint/types/validator.proto Validator
        {address=1, PublicKey pub_key=2, voting_power=3,
        proposer_priority=4}."""
        w = Writer()
        w.bytes(1, self.address)
        w.message(2, pubkey_proto_writer(self.pub_key))
        w.varint(3, self.voting_power)
        # two's-complement for possibly-negative priority
        w.varint(4, self.proposer_priority)
        return w

    @classmethod
    def from_bytes(cls, data: bytes) -> "Validator":
        r = Reader(data)
        addr = b""
        pk = None
        power = 0
        prio = 0
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                addr = r.bytes()
            elif f == 2:
                pk = pubkey_from_proto_bytes(r.bytes())
            elif f == 3:
                power = r.varint()
            elif f == 4:
                prio = r.varint()
            else:
                r.skip(wt)
        if pk is None:
            raise ValueError("validator missing pubkey")
        return cls(addr or pk.address(), pk, power, prio)
