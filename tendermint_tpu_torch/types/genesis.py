"""Genesis document (reference: types/genesis.py; Go
types/genesis.go). Its keys are ed25519, sr25519 or secp256k1, the
types crypto/__init__.py registers."""

from __future__ import annotations

import base64
import json
import time as _time
from dataclasses import dataclass, field

from .. import crypto
from ..crypto import tmhash
from .params import ConsensusParams
from .validator import Validator

MAX_CHAIN_ID_LEN = 50

# Go tmjson key-type tags (crypto/encoding + amino-era names)
_REF_KEY_TYPES = {
    "tendermint/PubKeyEd25519": "ed25519",
    "tendermint/PubKeySecp256k1": "secp256k1",
    "tendermint/PubKeySr25519": "sr25519",
}


def _pub_key_from_json(pk: dict) -> "crypto.PubKey":
    """{'type','value'} with either repo conventions (short type name,
    hex value) or Go tmjson (amino-style tag, base64 value). A type the
    port does not register raises as unknown before any decoding (the
    reference would go on to a base64 decode of the hex value)."""
    tname = _REF_KEY_TYPES.get(pk["type"], pk["type"])
    if tname not in crypto.pubkey_types():
        raise ValueError(f"unknown pubkey type {tname!r}")
    raw = pk["value"]
    try:
        return crypto.pubkey_from_type_and_bytes(tname, bytes.fromhex(raw))
    except ValueError:
        return crypto.pubkey_from_type_and_bytes(
            tname, base64.b64decode(raw))


@dataclass
class GenesisValidator:
    pub_key: crypto.PubKey
    power: int
    name: str = ""

    @property
    def address(self) -> bytes:
        return self.pub_key.address()


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: int = 0  # ns
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: dict | list | str | None = None

    def validate_and_complete(self) -> None:
        if not self.chain_id or len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("bad chain id")
        if self.initial_height < 0:
            raise ValueError("negative initial height")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        for v in self.validators:
            if v.power < 0:
                raise ValueError("negative validator power")
        if self.genesis_time == 0:
            self.genesis_time = _time.time_ns()

    def validator_set(self):
        from .validator_set import ValidatorSet

        return ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in self.validators]
        )

    def hash(self) -> bytes:
        return tmhash.sum256(self.to_json().encode())

    def to_json(self) -> str:
        return json.dumps(
            {
                "chain_id": self.chain_id,
                "genesis_time": self.genesis_time,
                "initial_height": self.initial_height,
                "consensus_params": self.consensus_params.to_json(),
                "validators": [
                    {
                        "pub_key": {
                            "type": v.pub_key.type_name,
                            "value": v.pub_key.bytes().hex(),
                        },
                        "power": v.power,
                        "name": v.name,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex(),
                "app_state": self.app_state,
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "GenesisDoc":
        """Accepts this repo's JSON AND the Go reference's tmjson format
        (types/genesis.go: RFC3339 genesis_time, string-encoded int64s,
        'tendermint/PubKeyEd25519'-style key types with base64 values)
        — a Go operator's genesis.json loads unchanged."""
        d = json.loads(s)
        gt = d.get("genesis_time", 0)
        if isinstance(gt, str):
            from ..libs.timeenc import rfc3339_to_ns

            gt = rfc3339_to_ns(gt)
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time=gt,
            initial_height=int(d.get("initial_height") or 1),
            consensus_params=ConsensusParams.from_json(
                d.get("consensus_params")
            ),
            validators=[
                GenesisValidator(
                    pub_key=_pub_key_from_json(gv["pub_key"]),
                    power=int(gv["power"]),
                    name=gv.get("name") or "",
                )
                for gv in d.get("validators") or []
            ],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state"),
        )
        doc.validate_and_complete()
        return doc

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
