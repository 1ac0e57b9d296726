"""Virtual time for deterministic simulation (reference:
tendermint_tpu/sim/clock.py).

The sim event loop is a stock asyncio SelectorEventLoop with three
twists:

1. ``loop.time()`` reads a VirtualClock instead of the OS monotonic
   clock.
2. The selector never blocks: when asyncio would sleep ``timeout``
   seconds waiting for the earliest timer, the clock jumps forward by
   exactly that much instead. Every ``call_later`` / ``asyncio.sleep``
   / ``wait_for`` in the process — consensus timeouts, gossip pacing,
   flush deadlines, breaker probes — fires in order on SIMULATED time
   at whatever rate the host CPU can drain callbacks.
3. ``loop.run_in_executor`` runs the function INLINE and returns an
   already-completed future. Thread completions land at wall-clock-
   dependent instants and would otherwise interleave differently on
   every run; inline execution keeps the event order a pure function
   of the program + seed. (Sim workloads keep executor jobs small —
   the vote scheduler is disabled in sim configs anyway.)

The same VirtualClock is installed into libs/clock.py for the non-loop
control-flow reads (token buckets, trust ticks, breaker cooldowns), so
``loop.time()`` and ``clock.monotonic()`` share one timebase.

A loop iteration with nothing ready, no timer scheduled and no real
I/O possible can never make progress again: that is a genuine
deadlock of the simulated net, surfaced immediately as SimStallError
instead of a hung test.
"""

from __future__ import annotations

import asyncio
import selectors


class SimStallError(RuntimeError):
    """The sim loop went idle with no timers scheduled — the simulated
    net is deadlocked (nothing can ever wake it again)."""


class VirtualClock:
    """Monotonic simulated seconds + a coherent epoch-anchored
    time_ns(). The epoch is a fixed constant so simulated wall-clock
    timestamps (vote times, WAL timestamps) are identical across
    runs AND across machines."""

    EPOCH_NS = 1_750_000_000 * 1_000_000_000  # fixed, arbitrary

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    # -- time source surface (libs/clock.py + loop.time) --

    def time(self) -> float:
        return self._now

    monotonic = time

    def time_ns(self) -> int:
        return self.EPOCH_NS + int(self._now * 1e9)

    # -- advancement (the sim selector only) --

    def advance(self, dt: float) -> None:
        assert dt >= 0.0
        self._now += dt


class _SimSelector:
    """Selector wrapper: a blocking select(timeout) becomes a virtual
    jump of `timeout` plus a zero-timeout poll of the real selector
    (the loop's self-pipe stays registered; sim transports register no
    fds, so the poll is effectively a formality)."""

    def __init__(self, clock: VirtualClock, inner=None):
        self.clock = clock
        self.inner = inner or selectors.DefaultSelector()

    def select(self, timeout=None):
        if timeout is None:
            raise SimStallError(
                "sim loop idle with no scheduled timers at virtual "
                f"t={self.clock.time():.3f}s — simulated net deadlocked")
        if timeout > 0:
            self.clock.advance(timeout)
        return self.inner.select(0)

    # plain delegation for the rest of the selector protocol
    def register(self, *a, **kw):
        return self.inner.register(*a, **kw)

    def unregister(self, *a, **kw):
        return self.inner.unregister(*a, **kw)

    def modify(self, *a, **kw):
        return self.inner.modify(*a, **kw)

    def close(self):
        return self.inner.close()

    def get_map(self):
        return self.inner.get_map()

    def get_key(self, fileobj):
        return self.inner.get_key(fileobj)


def new_sim_loop(vclock: VirtualClock) -> asyncio.AbstractEventLoop:
    """A fresh event loop driven by `vclock`. Close it when done."""
    loop = asyncio.SelectorEventLoop(_SimSelector(vclock))
    loop.time = vclock.time  # instance override; timers go virtual

    def _inline_run_in_executor(executor, func, *args):
        fut = loop.create_future()
        try:
            fut.set_result(func(*args))
        except BaseException as e:  # mirrors executor future semantics
            fut.set_exception(e)
        return fut

    loop.run_in_executor = _inline_run_in_executor
    return loop
