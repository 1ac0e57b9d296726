"""Retry backoff (reference: libs/net.py, trimmed to the policy the
device breakers use)."""

from __future__ import annotations

import random


def jittered_backoff(attempt: int, base: float, cap: float) -> float:
    """The retry-delay policy: capped exponential from `base` with
    ±20 % uniform jitter, so retriers never act in lockstep. `attempt`
    is 0-based."""
    return min(base * 2 ** attempt, cap) * (0.8 + 0.4 * random.random())
