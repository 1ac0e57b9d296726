"""Flow-rate measurement and limiting (reference: libs/flowrate.py;
Go libs/flowrate).

An EWMA byte-rate monitor used by p2p connections to cap send/recv
rates. ``limit`` returns how many bytes may be transferred now to stay
under the target rate; the caller sleeps when 0.
"""

from __future__ import annotations

from . import clock


class Monitor:
    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._period = sample_period
        self._alpha = sample_period / window
        self._rate = 0.0
        self._sample_bytes = 0
        self._sample_start = clock.monotonic()
        self.total = 0
        self.start_time = self._sample_start
        self._tokens = 0.0
        self._token_time: float | None = None

    def update(self, n: int) -> None:
        self.total += n
        self._sample_bytes += n
        now = clock.monotonic()
        elapsed = now - self._sample_start
        if elapsed >= self._period:
            inst = self._sample_bytes / elapsed
            self._rate += self._alpha * (inst - self._rate)
            self._sample_bytes = 0
            self._sample_start = now

    @property
    def rate(self) -> float:
        return self._rate

    def limit(self, want: int, rate_limit: int) -> int:
        """Bytes allowed now under a token bucket with ~1 s of burst.

        Idle time earns tokens only up to the burst cap, so a
        long-idle connection cannot blast unbounded backlog (the
        lifetime-average formulation would allow exactly that).
        """
        if rate_limit <= 0:
            return want
        self._refill(rate_limit)
        allowed = min(want, int(self._tokens))
        self._tokens -= allowed
        return allowed

    def _refill(self, rate_limit: int) -> None:
        now = clock.monotonic()
        if self._token_time is None:
            self._tokens = float(rate_limit)  # full initial burst
        else:
            self._tokens = min(
                float(rate_limit),
                self._tokens + rate_limit * (now - self._token_time),
            )
        self._token_time = now

    def sleep_time(self, rate_limit: int) -> float:
        """How long until at least one byte of budget frees up."""
        if rate_limit <= 0:
            return 0.0
        self._refill(rate_limit)
        if self._tokens >= 1:
            return 0.0
        return (1 - self._tokens) / rate_limit
