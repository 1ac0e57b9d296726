"""Coordinated backpressure and load shedding (reference:
libs/overload.py), trimmed to the aggregate controller.

Every queue that can grow under external input is bounded, counts what
it sheds, and registers with the process-global ``CONTROLLER``, which
aggregates saturation into one ok/pressured/shedding level. The port's
tracked queues so far are the consensus receive funnel's two classes
(``consensus.funnel.votes`` and ``consensus.funnel.data``, the
PriorityFunnel below, owned by consensus/state.py ConsensusState), the
vote scheduler's buffer (``consensus.vote_buf``), the light verify
collector's backlog (``light.pending_verify``, light/serving.py), the
mempool (``mempool.pool``, mempool/clist_mempool.py) and its admission
pre-verify backlog (``mempool.preverify``, mempool/admission.py).

The reference also exports depth/capacity gauges and a shed counter
through its metrics library; the port keeps the shed counts in
``OverloadController.sheds``, a plain dict (crypto/batch.py METRICS
convention). Advisory sheds (the funnel's already-tallied duplicate
votes) count there without driving the level, as in the reference.
DropOldestQueue, the slow-peer bookkeeping, advisory queues and the
configurable shed window come with the p2p port.
"""

from __future__ import annotations

import asyncio
import collections
from dataclasses import dataclass

from . import clock

PRESSURED_RATIO = 0.75
SHEDDING_RATIO = 0.95
# the level stays "shedding" for this long after the last shed, so a
# poll slower than a burst still sees it
SHED_WINDOW_S = 10.0


@dataclass
class _Tracked:
    name: str
    depth_fn: object       # () -> int
    capacity_fn: object    # () -> int
    owner: object = None    # identity for owner-checked unregister


class OverloadController:
    """Aggregates queue-saturation signals into one overload level.

    Registration replaces by name (several in-process owners share the
    process-global singleton; monitoring tracks the latest).
    evaluate() is pull-based: depth functions run only on an explicit
    call, never on the hot path. The only hot-path entry point is
    shed(), one counter increment plus a monotonic timestamp."""

    def __init__(self):
        self._queues: dict[str, _Tracked] = {}
        self._last_shed = 0.0
        self.sheds: dict[str, int] = {}  # queue -> items shed

    def register(self, name: str, depth_fn, capacity,
                 owner: object = None) -> None:
        """Track a bounded queue. `capacity` is an int or a callable.
        `owner` lets the registrant unregister on teardown without
        clobbering a newer same-name registration."""
        cap_fn = capacity if callable(capacity) else (lambda c=capacity: c)
        self._queues[name] = _Tracked(name, depth_fn, cap_fn, owner)

    def unregister(self, name: str, owner: object = None) -> None:
        """Remove a tracked queue. With `owner` set, only removes the
        entry if that owner still holds the registration."""
        cur = self._queues.get(name)
        if cur is None:
            return
        if owner is not None and cur.owner is not None \
                and cur.owner is not owner:
            return
        del self._queues[name]

    def shed(self, queue: str, n: int = 1, advisory: bool = False) -> None:
        """Record `n` items dropped by policy from `queue`. Advisory
        sheds count but do not drive the level: dropping a vote that is
        already tallied loses nothing."""
        self.sheds[queue] = self.sheds.get(queue, 0) + n
        if not advisory:
            self._last_shed = clock.monotonic()

    def evaluate(self) -> dict:
        """Every tracked queue's depth and capacity, and the level. A
        depth/capacity callable that raises (its owner was stopped
        mid-poll) reads as empty."""
        queues: dict[str, dict] = {}
        worst = 0.0
        for t in list(self._queues.values()):
            try:
                depth = float(t.depth_fn())
                cap = float(t.capacity_fn())
            except Exception:
                depth, cap = 0.0, 0.0
            fill = depth / cap if cap > 0 else 0.0
            queues[t.name] = {"depth": int(depth), "capacity": int(cap),
                              "fill": round(fill, 3)}
            worst = max(worst, fill)
        recent_shed = clock.monotonic() - self._last_shed < SHED_WINDOW_S
        if worst >= SHEDDING_RATIO or recent_shed:
            level = "shedding"
        elif worst >= PRESSURED_RATIO:
            level = "pressured"
        else:
            level = "ok"
        return {"level": level, "worst_fill": round(worst, 3),
                "queues": queues}


# The process-global controller every subsystem registers with.
CONTROLLER = OverloadController()


class PriorityFunnel:
    """Two-class bounded funnel for the consensus receive routine
    (reference: libs/overload.py PriorityFunnel).

    High-class (vote/proposal) messages apply BACKPRESSURE: a full queue
    blocks the producing peer's recv task, like the Go reference's
    `cs.peerMsgQueue <- msgInfo` channel send. Low-class (block parts /
    catchup data) messages SHED when full: they are re-gossiped on
    demand, so dropping the newest under flood is safe. get() drains
    high first with bounded aging: after LOW_SERVICE_INTERVAL
    consecutive high pops a low item is served, but only one that
    arrived before every queued high item — a block part processed
    before its proposal is dropped (its PartSet does not exist yet), so
    aging must never reorder a part ahead of the proposal it belongs
    to."""

    # one aged low-class item per this many consecutive high pops
    LOW_SERVICE_INTERVAL = 8

    def __init__(self, high_capacity: int, low_capacity: int,
                 high_queue: str, low_queue: str,
                 controller: OverloadController | None = None):
        self.high_capacity = high_capacity
        self.low_capacity = low_capacity
        self.high_queue = high_queue
        self.low_queue = low_queue
        self._controller = controller or CONTROLLER
        self._high: collections.deque = collections.deque()  # (seq, item)
        self._low: collections.deque = collections.deque()   # (seq, item)
        self._high_streak = 0
        self._seq = 0  # arrival order across both classes
        self._not_empty = asyncio.Event()
        self._high_space = asyncio.Event()
        self._high_space.set()
        self._controller.register(high_queue, lambda: len(self._high),
                                  high_capacity, owner=self)
        self._controller.register(low_queue, lambda: len(self._low),
                                  low_capacity, owner=self)

    def close(self) -> None:
        """Drop this funnel's registrations (no-op if a newer funnel
        took over the names)."""
        self._controller.unregister(self.high_queue, owner=self)
        self._controller.unregister(self.low_queue, owner=self)

    def high_depth(self) -> int:
        return len(self._high)

    def low_depth(self) -> int:
        return len(self._low)

    def qsize(self) -> int:
        return len(self._high) + len(self._low)

    def pressured(self, ratio: float = 0.5) -> bool:
        """Cheap saturation probe for admission-time decisions (shed
        duplicate votes only once the funnel is half full)."""
        return (len(self._high) >= ratio * self.high_capacity
                or len(self._low) >= ratio * self.low_capacity)

    async def get(self):
        """Next message, high class first, with the aging above.
        Single consumer; safe against the consumer's wait being
        cancelled between items."""
        while True:
            aged_low = (self._low
                        and self._high_streak >= self.LOW_SERVICE_INTERVAL
                        and (not self._high
                             or self._low[0][0] < self._high[0][0]))
            if self._high and not aged_low:
                _, item = self._high.popleft()
                self._high_streak += 1
                if len(self._high) < self.high_capacity:
                    self._high_space.set()
                return item
            if self._low:
                self._high_streak = 0
                return self._low.popleft()[1]
            self._not_empty.clear()
            await self._not_empty.wait()

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    async def put_high(self, item) -> None:
        """Blocking admit: backpressure onto the caller when full."""
        while len(self._high) >= self.high_capacity:
            self._high_space.clear()
            await self._high_space.wait()
        self._high.append((self._next_seq(), item))
        self._not_empty.set()

    def put_high_nowait(self, item) -> None:
        """Non-blocking admit; raises QueueFull (sync call sites)."""
        if len(self._high) >= self.high_capacity:
            raise asyncio.QueueFull
        self._high.append((self._next_seq(), item))
        self._not_empty.set()

    def put_low(self, item) -> bool:
        """Admit or shed: a full data queue drops the NEWEST message
        (counted) and never blocks."""
        if len(self._low) >= self.low_capacity:
            self._controller.shed(self.low_queue)
            return False
        self._low.append((self._next_seq(), item))
        self._not_empty.set()
        return True
