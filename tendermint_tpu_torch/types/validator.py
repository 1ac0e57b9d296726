"""Validators (reference: types/validator.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import PubKey
from ..encoding.proto import Writer

# crypto.PublicKey oneof field numbers (reference:
# proto/tendermint/crypto/keys.proto — ed25519=1, secp256k1=2;
# sr25519=3 follows the upstream tendermint v0.35 assignment).
_PK_ONEOF = {"ed25519": 1, "secp256k1": 2, "sr25519": 3}


def pubkey_proto_writer(pk: PubKey) -> Writer:
    w = Writer()
    w.bytes(_PK_ONEOF[pk.type_name], pk.bytes(), skip_empty=False)
    return w


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
