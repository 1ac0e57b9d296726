"""Adapter for the Go reference's TLA+-generated light-client MBT corpus
(reference: tendermint_tpu/light/mbt_ref.py, the same schema and
verdicts; Go light/mbt/doc.go:1-20, light/mbt/json/*.json,
driver_test.go), driving the port's light/verifier.py.

The corpus is the only externally-derived test oracle available to
this repo: its fixtures carry REAL signed headers and validator sets
produced over the reference implementation's canonical sign-bytes and
hashing (generated from the TLA+ light-client spec via tendermint-rs
testgen). Replaying them through this package's verifier therefore
cross-validates, in one sweep:

  * canonical vote sign-bytes (types/canonical.py field layout),
  * header hashing (types/block.py Header.hash: cdcEncode field
    merkle),
  * validator-set hashing (SimpleValidator encoding + ordering),
  * ed25519 signature verification,
  * the verifier's trust/adjacency/expiry/drift verdict logic
    (reference: light/verifier.go Verify),

because a commit only verifies if every byte of the recomputed
sign-bytes and every recomputed hash matches what the reference
signed. Any divergence is a real encoding bug or must be documented.

Fixture schema (reference tmjson encoding): string-encoded int64s,
base64 keys/signatures, hex hashes/addresses, RFC3339 times with
nanoseconds. Driver semantics mirror driver_test.go exactly: the
trusted state carries the *next* validator set of the latest trusted
header (tendermint-rs convention — driver_test.go:104-118), each step
runs one verify at the step's `now` with maxClockDrift=1s, SUCCESS
advances the trusted state, NOT_ENOUGH_TRUST and INVALID leave it.
"""

from __future__ import annotations

import base64
import json
from fractions import Fraction

from ..crypto import ed25519
from ..libs.timeenc import rfc3339_to_ns as _time_ns
from ..types.block import (
    BlockID,
    BlockIDFlag,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet
from .errors import LightClientError, NewValSetCantBeTrustedError
from .types import LightBlock, SignedHeader
from .verifier import verify

SUCCESS = "SUCCESS"
NOT_ENOUGH_TRUST = "NOT_ENOUGH_TRUST"
INVALID = "INVALID"

# driver_test.go passes 1 * time.Second
MAX_CLOCK_DRIFT_NS = 1_000_000_000


def _hex(s: str | None) -> bytes:
    return bytes.fromhex(s) if s else b""


def _block_id(d: dict | None) -> BlockID | None:
    if d is None:
        return None
    psh = d.get("part_set_header") or d.get("parts")
    return BlockID(
        _hex(d.get("hash")),
        PartSetHeader(int(psh["total"]), _hex(psh.get("hash")))
        if psh else None,
    )


def _header(d: dict) -> Header:
    ver = d.get("version") or {}
    return Header(
        version_block=int(ver.get("block") or 0),
        version_app=int(ver.get("app") or 0),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=_time_ns(d["time"]),
        last_block_id=_block_id(d.get("last_block_id")),
        last_commit_hash=_hex(d.get("last_commit_hash")),
        data_hash=_hex(d.get("data_hash")),
        validators_hash=_hex(d.get("validators_hash")),
        next_validators_hash=_hex(d.get("next_validators_hash")),
        consensus_hash=_hex(d.get("consensus_hash")),
        app_hash=_hex(d.get("app_hash")),
        last_results_hash=_hex(d.get("last_results_hash")),
        evidence_hash=_hex(d.get("evidence_hash")),
        proposer_address=_hex(d.get("proposer_address")),
    )


def _commit(d: dict) -> Commit:
    sigs = []
    for s in d.get("signatures") or []:
        flag = int(s["block_id_flag"])
        if flag == BlockIDFlag.ABSENT:
            sigs.append(CommitSig.absent())
            continue
        sigs.append(CommitSig(
            flag,
            _hex(s.get("validator_address")),
            _time_ns(s["timestamp"]) if s.get("timestamp") else 0,
            base64.b64decode(s["signature"]) if s.get("signature")
            else b"",
        ))
    return Commit(
        height=int(d["height"]),
        round=int(d.get("round") or 0),
        block_id=_block_id(d["block_id"]),
        signatures=sigs,
    )


def _valset(d: dict | None) -> ValidatorSet:
    vals = []
    for v in (d or {}).get("validators") or []:
        pk = v["pub_key"]
        if "ed25519" not in pk["type"].lower():
            raise ValueError(f"unsupported key type {pk['type']!r}")
        pub = ed25519.Ed25519PubKey(base64.b64decode(pk["value"]))
        vals.append(Validator(
            address=_hex(v["address"]),
            pub_key=pub,
            voting_power=int(v["voting_power"]),
            proposer_priority=int(v["proposer_priority"] or 0)
            if v.get("proposer_priority") is not None else 0,
        ))
    return ValidatorSet(vals)


def _signed_header(d: dict) -> SignedHeader:
    return SignedHeader(_header(d["header"]), _commit(d["commit"]))


def classify(chain_id: str, trusted: LightBlock, untrusted: LightBlock,
             trusting_period_ns: int, now_ns: int,
             trust_level: Fraction) -> str:
    try:
        verify(chain_id, trusted, untrusted, trusting_period_ns, now_ns,
               trust_level, max_clock_drift_ns=MAX_CLOCK_DRIFT_NS)
        return SUCCESS
    except NewValSetCantBeTrustedError:
        return NOT_ENOUGH_TRUST
    except (LightClientError, ValueError):
        return INVALID


def run_case(doc: dict) -> list[str]:
    """Replay one reference corpus case; returns the verdict list.
    Raises AssertionError on the first divergence from the fixture's
    expected verdicts."""
    init = doc["initial"]
    trusted_sh = _signed_header(init["signed_header"])
    chain_id = trusted_sh.header.chain_id
    # tendermint-rs convention: the verifier state carries the NEXT
    # valset of the trusted header (driver_test.go trustedNextVals)
    trusted = LightBlock(trusted_sh, _valset(init["next_validator_set"]))
    period = int(init["trusting_period"])
    verdicts = []
    for i, step in enumerate(doc["input"]):
        blk = step["block"]
        untrusted = LightBlock(_signed_header(blk["signed_header"]),
                               _valset(blk.get("validator_set")))
        got = classify(chain_id, trusted, untrusted, period,
                       _time_ns(step["now"]), Fraction(1, 3))
        verdicts.append(got)
        want = step["verdict"]
        assert got == want, (
            f"{doc.get('description', '?')}: step {i} (height "
            f"{untrusted.height()}): got {got}, want {want}")
        if got == SUCCESS:
            trusted = LightBlock(
                untrusted.signed_header,
                _valset(blk.get("next_validator_set")))
    return verdicts


def run_case_file(path: str) -> list[str]:
    with open(path) as f:
        return run_case(json.load(f))
