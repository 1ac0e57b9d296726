"""Fast sync: catch up to the chain head by downloading committed
blocks from peers and verifying them without running consensus
(reference: blockchain/ — v0 pool design with v2's deterministic,
IO-free core for testability).

Block verification during catch-up is the hottest loop — one
VerifyCommitLight per block. Here contiguous runs of fetched blocks are
verified as ONE signature batch across blocks (verify_ahead.py: one
structured K3 launch a window over the set's cached comb tables), and
the next window's batch verifies while the caller handles this one.

This slice of the port carries the pure core: the pool, the wire
messages and the verify-ahead window pipeline. The reactor, which
needs the p2p stack, the block store and the block executor, comes
with a later slice.
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

__all__ = [
    "BlockPool",
    "StatusRequestMessage", "StatusResponseMessage", "BlockRequestMessage",
    "BlockResponseMessage", "NoBlockResponseMessage",
    "encode_bc_msg", "decode_bc_msg",
]
