"""Header verification rules (reference: light/verifier.go).

verify_adjacent  (:102): heights differ by 1 — the trusted header's
next_validators_hash must equal the new header's validators_hash, then
the new valset's commit is checked (+2/3, batched).

verify_non_adjacent (:33): any height gap — the TRUSTED valset must
have signed the new commit with ≥ trust-level (default 1/3) of its
power (batched, address-matched), then the new valset's own commit is
checked (+2/3, batched). Raises NewValSetCantBeTrustedError when the
overlap is insufficient, which drives the client's bisection."""

from __future__ import annotations

from fractions import Fraction

from ..types.validator_set import VerificationError
from .errors import (
    NewValSetCantBeTrustedError,
    OutsideTrustingPeriodError,
    VerificationFailedError,
)
from .types import LightBlock

DEFAULT_TRUST_LEVEL = Fraction(1, 3)
MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000  # reference defaultMaxClockDrift


def _common_checks(chain_id: str, trusted: LightBlock,
                   untrusted: LightBlock, trusting_period_ns: int,
                   now_ns: int,
                   max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS) -> None:
    untrusted.validate_basic(chain_id)
    if untrusted.height() <= trusted.height():
        raise VerificationFailedError(
            f"target height {untrusted.height()} not above trusted "
            f"{trusted.height()}")
    # the trusted header must still be inside its trusting period,
    # else its valset may have long unbonded (reference HeaderExpired)
    if trusted.time() + trusting_period_ns <= now_ns:
        raise OutsideTrustingPeriodError(
            f"trusted header from {trusted.time()} expired")
    if untrusted.time() <= trusted.time():
        raise VerificationFailedError(
            "untrusted header time not after trusted header time")
    if untrusted.time() >= now_ns + max_clock_drift_ns:
        raise VerificationFailedError(
            "untrusted header is from the future (clock drift exceeded)")


def verify_adjacent(chain_id: str, trusted: LightBlock,
                    untrusted: LightBlock, trusting_period_ns: int,
                    now_ns: int,
                    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS) -> None:
    if untrusted.height() != trusted.height() + 1:
        raise VerificationFailedError("headers must be adjacent")
    _common_checks(chain_id, trusted, untrusted, trusting_period_ns,
                   now_ns, max_clock_drift_ns)
    if untrusted.signed_header.header.validators_hash != \
            trusted.signed_header.header.next_validators_hash:
        raise VerificationFailedError(
            "new validators_hash != trusted next_validators_hash")
    sh = untrusted.signed_header
    try:
        untrusted.validator_set.verify_commit_light(
            chain_id, sh.commit.block_id, sh.header.height, sh.commit)
    except VerificationError as e:
        raise VerificationFailedError(f"invalid commit: {e}") from e


def verify_non_adjacent(chain_id: str, trusted: LightBlock,
                        untrusted: LightBlock, trusting_period_ns: int,
                        now_ns: int,
                        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                        max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS) -> None:
    if untrusted.height() == trusted.height() + 1:
        return verify_adjacent(chain_id, trusted, untrusted,
                               trusting_period_ns, now_ns,
                               max_clock_drift_ns)
    _common_checks(chain_id, trusted, untrusted, trusting_period_ns,
                   now_ns, max_clock_drift_ns)
    sh = untrusted.signed_header
    # ≥ trust-level of the TRUSTED valset must have signed the new block
    try:
        trusted.validator_set.verify_commit_light_trusting(
            chain_id, sh.commit,
            trust_level.numerator, trust_level.denominator)
    except VerificationError as e:
        raise NewValSetCantBeTrustedError(str(e)) from e
    # and the new valset itself must have +2/3 committed it
    try:
        untrusted.validator_set.verify_commit_light(
            chain_id, sh.commit.block_id, sh.header.height, sh.commit)
    except VerificationError as e:
        raise VerificationFailedError(f"invalid commit: {e}") from e


def verify_backwards(untrusted_header, trusted_header) -> None:
    """Hash-chain verification of an OLDER header against a newer
    trusted one (reference: light/verifier.go:196 VerifyBackwards):
    the trusted header's last_block_id must be the hash of the older
    header — no signatures needed, the chain linkage is the proof."""
    untrusted_header.validate_basic()
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise VerificationFailedError(
            f"older header from a different chain "
            f"({untrusted_header.chain_id!r} != "
            f"{trusted_header.chain_id!r})")
    if untrusted_header.time >= trusted_header.time:
        raise VerificationFailedError(
            "older header time not before trusted header time")
    if trusted_header.last_block_id is None or \
            untrusted_header.hash() != trusted_header.last_block_id.hash:
        raise VerificationFailedError(
            "older header hash does not match trusted header's "
            "last_block_id")


def verify(chain_id: str, trusted: LightBlock, untrusted: LightBlock,
           trusting_period_ns: int, now_ns: int,
           trust_level: Fraction = DEFAULT_TRUST_LEVEL,
           max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS) -> None:
    """reference: light/verifier.go:150 Verify — dispatch on adjacency."""
    if untrusted.height() == trusted.height() + 1:
        verify_adjacent(chain_id, trusted, untrusted, trusting_period_ns,
                        now_ns, max_clock_drift_ns)
    else:
        verify_non_adjacent(chain_id, trusted, untrusted,
                            trusting_period_ns, now_ns, trust_level,
                            max_clock_drift_ns)
