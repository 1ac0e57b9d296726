"""Light client: verify chain headers without executing blocks
(reference: light/).

A light client tracks a chain by verifying SignedHeaders against
validator sets it already trusts — adjacent headers by valset-hash
continuity, distant headers by the +1/3-trust overlap rule with
bisection (Go reference light/client.go:114, verifier.go:33,102).
Every commit check rides the batched surfaces of ValidatorSet, and the
serving plane's verify collector (serving.py) pools the checks of many
requests into one wide launch; the light proxy (proxy.py) serves
verified RPC, and ServingPool puts several proxies in front of one
plane. RPCProvider fetches light blocks over a node's JSON-RPC."""

from .client import Client, TrustOptions
from .errors import (
    DivergenceError,
    LightClientError,
    NewValSetCantBeTrustedError,
    OutsideTrustingPeriodError,
    VerificationFailedError,
)
from .provider import BlockStoreProvider, Provider, RPCProvider
from .serving import (
    LightServingShedError,
    LightVerifyCollector,
    ServingPlane,
    ServingPool,
    VerifiedHeaderCache,
    verify_through,
)
from .store import LightStore
from .types import LightBlock, LightClientAttackEvidence, SignedHeader
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)

__all__ = [
    "Client", "TrustOptions", "LightBlock", "SignedHeader",
    "LightClientAttackEvidence", "LightStore", "Provider",
    "BlockStoreProvider", "RPCProvider", "ServingPlane", "ServingPool",
    "VerifiedHeaderCache",
    "LightVerifyCollector", "LightServingShedError", "verify_through",
    "verify", "verify_adjacent", "verify_non_adjacent", "verify_backwards",
    "DEFAULT_TRUST_LEVEL", "LightClientError", "VerificationFailedError",
    "NewValSetCantBeTrustedError", "OutsideTrustingPeriodError",
    "DivergenceError",
]
