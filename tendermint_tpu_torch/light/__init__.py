"""Light client verification (reference: light/): verify chain headers
without executing blocks.

A light client tracks a chain by verifying SignedHeaders against
validator sets it already trusts — adjacent headers by valset-hash
continuity, distant headers by the +1/3-trust overlap rule (Go
reference light/verifier.go:33,102). Every commit check rides the
batched surfaces of ValidatorSet, and the verify collector
(serving.py) pools the checks of many requests into one wide launch.
The Client (bisection, witnesses, the detector), its providers and
store, and the ServingPlane come with a later slice of the port."""

from .errors import (
    DivergenceError,
    LightClientError,
    NewValSetCantBeTrustedError,
    OutsideTrustingPeriodError,
    VerificationFailedError,
)
from .serving import (
    LightServingShedError,
    LightVerifyCollector,
    VerifiedHeaderCache,
    verify_through,
)
from .types import LightBlock, LightClientAttackEvidence, SignedHeader
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)

__all__ = [
    "LightBlock", "SignedHeader", "LightClientAttackEvidence",
    "VerifiedHeaderCache", "LightVerifyCollector", "LightServingShedError",
    "verify_through", "verify", "verify_adjacent", "verify_non_adjacent",
    "verify_backwards", "DEFAULT_TRUST_LEVEL",
    "LightClientError", "VerificationFailedError",
    "NewValSetCantBeTrustedError", "OutsideTrustingPeriodError",
    "DivergenceError",
]
