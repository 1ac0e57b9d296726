"""Light client error taxonomy (reference: light/errors.go)."""

from __future__ import annotations


class LightClientError(Exception):
    pass


class VerificationFailedError(LightClientError):
    """Header failed verification — definitive rejection."""


class NewValSetCantBeTrustedError(LightClientError):
    """<1/3 trusted overlap at this distance: bisect closer
    (reference: types.ErrNotEnoughVotingPowerSigned → bisection)."""


class OutsideTrustingPeriodError(LightClientError):
    pass


class DivergenceError(LightClientError):
    """A witness disagrees with the primary — possible attack
    (reference: light/detector.go ErrConflictingHeaders)."""

    def __init__(self, witness_index: int, witness_block, primary_block):
        self.witness_index = witness_index
        self.witness_block = witness_block
        self.primary_block = primary_block
        # Filled by the detector once the fork is proven: the two
        # LightClientAttackEvidence objects submitted to each side.
        self.evidence: list = []
        super().__init__(
            f"witness {witness_index} header conflicts with primary at "
            f"height {primary_block.height()}")
