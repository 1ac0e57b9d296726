"""Fast sync: catch up to the chain head by downloading committed
blocks from peers and verifying them without running consensus
(reference: blockchain/ — v0 pool design with v2's deterministic,
IO-free core for testability).

Block verification during catch-up is the hottest loop — one
VerifyCommitLight per block. Here contiguous runs of fetched blocks are
verified as ONE signature batch across blocks (verify_ahead.py: one
structured K3 launch a window over the set's cached comb tables), and
the next window's batch verifies while the caller handles this one.

The reactor (reactor.py: BlockchainReactor, BLOCKCHAIN_CHANNEL) is
loaded lazily, as in the reference: it is the only submodule that
pulls in the p2p stack.
"""

from .msgs import (
    BlockRequestMessage,
    BlockResponseMessage,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
    decode_bc_msg,
    encode_bc_msg,
)
from .pool import BlockPool


def __getattr__(name: str):
    if name in ("BlockchainReactor", "BLOCKCHAIN_CHANNEL"):
        from . import reactor

        return getattr(reactor, name)
    raise AttributeError(name)


__all__ = [
    "BlockPool", "BlockchainReactor", "BLOCKCHAIN_CHANNEL",
    "StatusRequestMessage", "StatusResponseMessage", "BlockRequestMessage",
    "BlockResponseMessage", "NoBlockResponseMessage",
    "encode_bc_msg", "decode_bc_msg",
]
