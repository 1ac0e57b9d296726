"""Model-based-test fixture driver for the light-client verifier
(reference: light/mbt/driver_test.go, which replays JSON fixtures
generated from the TLA+ light-client spec via tendermint-rs testgen).

Fixture schema (JSON):

    {
      "description": "...",
      "chain_id": "mbt-chain",
      "trust_level": [1, 3],
      "initial": {
        "block": "<hex of LightBlock proto bytes>",
        "trusting_period_ns": 3600000000000,
        "now_ns": 1700000001000000000
      },
      "input": [
        {"block": "<hex>", "now_ns": ..., "verdict": "SUCCESS"},
        {"block": "<hex>", "now_ns": ..., "verdict": "INVALID"},
        ...
      ]
    }

Driver semantics (same as the reference's): each input step runs ONE
`verify` of the step's block against the current trusted block at the
step's `now`; SUCCESS advances the trusted block, NOT_ENOUGH_TRUST
(insufficient trusted-valset overlap — the signal that drives
bisection) and INVALID leave it unchanged. The corpus lives in
tests/light_fixtures/ (generated in-repo by tests/gen_light_fixtures.py
— own generation, covering the trust-expiry x adjacency x
valset-rotation x attack lattice).
"""

from __future__ import annotations

import json
from fractions import Fraction

from .errors import (
    LightClientError,
    NewValSetCantBeTrustedError,
)
from .types import LightBlock
from .verifier import verify

SUCCESS = "SUCCESS"
NOT_ENOUGH_TRUST = "NOT_ENOUGH_TRUST"
INVALID = "INVALID"


def classify(chain_id: str, trusted: LightBlock, untrusted: LightBlock,
             trusting_period_ns: int, now_ns: int,
             trust_level: Fraction) -> str:
    """One verification attempt -> its fixture verdict."""
    try:
        verify(chain_id, trusted, untrusted, trusting_period_ns, now_ns,
               trust_level)
        return SUCCESS
    except NewValSetCantBeTrustedError:
        return NOT_ENOUGH_TRUST
    except (LightClientError, ValueError):
        # ValueError: validate_basic structural failures
        return INVALID


def run_fixture(doc: dict) -> list[str]:
    """Replay one fixture; returns the verdicts produced (for
    reporting). Raises AssertionError on the first divergence."""
    chain_id = doc["chain_id"]
    tl = doc.get("trust_level", [1, 3])
    trust_level = Fraction(tl[0], tl[1])
    init = doc["initial"]
    trusted = LightBlock.from_bytes(bytes.fromhex(init["block"]))
    period = int(init["trusting_period_ns"])
    verdicts = []
    for i, step in enumerate(doc["input"]):
        block = LightBlock.from_bytes(bytes.fromhex(step["block"]))
        got = classify(chain_id, trusted, block, period,
                       int(step["now_ns"]), trust_level)
        verdicts.append(got)
        want = step["verdict"]
        assert got == want, (
            f"{doc.get('description', '?')}: step {i} (height "
            f"{block.height()}): got {got}, want {want}")
        if got == SUCCESS:
            trusted = block
    return verdicts


def run_fixture_file(path: str) -> list[str]:
    with open(path) as f:
        return run_fixture(json.load(f))
