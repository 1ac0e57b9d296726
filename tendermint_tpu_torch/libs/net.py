"""Address and retry helpers (reference: libs/net.py): the node, its
RPC and the ABCI app creator split listen addresses; the device
breakers, the ABCI client's re-dial and p2p back off."""

from __future__ import annotations

import random


def split_laddr(laddr: str,
                default_host: str = "0.0.0.0") -> tuple[str, int]:
    """'tcp://host:port' or 'host:port' -> (host, port)."""
    addr = laddr[len("tcp://"):] if laddr.startswith("tcp://") else laddr
    host, _, port = addr.rpartition(":")
    return host or default_host, int(port)


def jittered_backoff(attempt: int, base: float, cap: float) -> float:
    """The retry-delay policy: capped exponential from `base` with
    ±20 % uniform jitter, so retriers never act in lockstep. `attempt`
    is 0-based."""
    return min(base * 2 ** attempt, cap) * (0.8 + 0.4 * random.random())
