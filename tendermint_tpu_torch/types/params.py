"""Consensus parameters (reference: types/params.py; Go
types/params.go). ``hash()`` feeds Header.consensus_hash, so its bytes
are the reference's."""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import asdict, dataclass, field

from ..crypto import tmhash
from ..encoding.proto import Writer

MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MB


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21 MB
    max_gas: int = -1
    time_iota_ms: int = 1000


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1048576


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(default_factory=lambda: ["ed25519"])


@dataclass
class VersionParams:
    app_version: int = 0


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)

    def validate_basic(self) -> None:
        if not 0 < self.block.max_bytes <= MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.max_bytes out of range")
        if self.block.max_gas < -1:
            raise ValueError("block.max_gas < -1")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be positive")
        if self.evidence.max_bytes > self.block.max_bytes:
            raise ValueError("evidence.max_bytes > block.max_bytes")
        if not self.validator.pub_key_types:
            raise ValueError("no validator pubkey types")

    def hash(self) -> bytes:
        """Deterministic hash stored in Header.consensus_hash."""
        w = Writer()
        w.varint(1, self.block.max_bytes)
        w.varint(2, self.block.max_gas + 1)  # shift so -1 encodes as 0
        w.varint(3, self.evidence.max_age_num_blocks)
        w.varint(4, self.evidence.max_age_duration_ns)
        w.varint(5, self.evidence.max_bytes)
        for t in self.validator.pub_key_types:
            w.string(6, t)
        w.varint(7, self.version.app_version)
        return tmhash.sum256(w.finish())

    def update(self, updates: dict | None) -> "ConsensusParams":
        """Apply ABCI EndBlock param updates (partial dict form)."""
        out = copy.deepcopy(self)
        if not updates:
            return out
        for section, vals in updates.items():
            target = getattr(out, section, None)
            if target is None:
                continue
            for k, v in vals.items():
                if hasattr(target, k):
                    setattr(target, k, v)
        out.validate_basic()
        return out

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict | None) -> "ConsensusParams":
        """Accepts both this repo's JSON and the Go reference's tmjson
        (string-encoded int64s, `max_age_duration`, null params —
        types/genesis.go ConsensusParams)."""
        d = d or {}

        def sec(name, klass, renames=()):
            raw = dict(d.get(name) or {})
            fields = {f.name for f in dataclasses.fields(klass)}
            out = {}
            for k, v in raw.items():
                k = dict(renames).get(k, k)
                if k not in fields:
                    # loud, not silent: a typo'd knob running with its
                    # default would be a config the operator didn't ask
                    # for (every tmjson key maps via renames)
                    raise ValueError(
                        f"unknown consensus_params.{name} key {k!r}")
                if isinstance(v, str) and v.lstrip("-").isdigit():
                    v = int(v)
                out[k] = v
            return klass(**out)

        return cls(
            block=sec("block", BlockParams),
            evidence=sec("evidence", EvidenceParams,
                         (("max_age_duration", "max_age_duration_ns"),)),
            validator=sec("validator", ValidatorParams),
            version=sec("version", VersionParams),
        )
