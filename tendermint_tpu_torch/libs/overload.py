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
pre-verify backlog (``mempool.preverify``, mempool/admission.py), and
the p2p send queues (``p2p.send``, p2p/switch.py).

Sheds count in the reference's overload family (overload_shed_total by
queue; evaluate() refreshes the depth, capacity and level gauges), and
each controller also keeps its own tally in ``sheds``. Advisory sheds (the funnel's already-tallied duplicate
votes, a DropOldestQueue's evictions) count there without driving the
level, as in the reference, and so do advisory queues: a drop-oldest
buffer sits full as its normal steady state.

Besides the controller and the funnel: ``DropOldestQueue`` (a bounded
queue that evicts its oldest entry) and the slow-peer bookkeeping
behind the p2p switch's escalation (``SlowPeerPolicy``,
``SlowPeerTracker``).
"""

from __future__ import annotations

import asyncio
import collections
from dataclasses import dataclass

from . import clock

PRESSURED_RATIO = 0.75
SHEDDING_RATIO = 0.95


@dataclass
class _Tracked:
    name: str
    depth_fn: object       # () -> int
    capacity_fn: object    # () -> int
    advisory: bool = False  # reported, but does not drive the level
    owner: object = None    # identity for owner-checked unregister


class OverloadController:
    """Aggregates queue-saturation signals into one overload level.

    Registration replaces by name (several in-process owners share the
    process-global singleton; monitoring tracks the latest).
    evaluate() is pull-based: depth functions run only on an explicit
    call, never on the hot path. The only hot-path entry point is
    shed(), one counter increment plus a monotonic timestamp."""

    def __init__(self, shed_window_s: float = 10.0):
        # the level stays "shedding" for this long after the last shed,
        # so a poll slower than a burst still sees it
        self.shed_window_s = shed_window_s
        self._queues: dict[str, _Tracked] = {}
        self._last_shed = 0.0
        self.sheds: dict[str, int] = {}  # queue -> items shed

    def register(self, name: str, depth_fn, capacity,
                 advisory: bool = False, owner: object = None) -> None:
        """Track a bounded queue. `capacity` is an int or a callable
        (queues whose bound scales with the peer count). An `advisory`
        queue is reported but does not drive the level: a drop-oldest
        buffer runs full under a slow consumer as its normal state, so
        only its shed events count. `owner` lets the registrant
        unregister on teardown without clobbering a newer same-name
        registration."""
        cap_fn = capacity if callable(capacity) else (lambda c=capacity: c)
        self._queues[name] = _Tracked(name, depth_fn, cap_fn, advisory,
                                      owner)

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
        from .metrics import overload_metrics

        overload_metrics().shed.inc(n, queue=queue)
        if not advisory:
            self._last_shed = clock.monotonic()

    def recent_shed(self) -> bool:
        return clock.monotonic() - self._last_shed < self.shed_window_s

    def evaluate(self) -> dict:
        """Every tracked queue's depth and capacity, and the level. A
        depth/capacity callable that raises (its owner was stopped
        mid-poll) reads as empty. Refreshes the family's gauges."""
        from .metrics import overload_metrics

        met = overload_metrics()
        queues: dict[str, dict] = {}
        worst = 0.0
        for t in list(self._queues.values()):
            try:
                depth = float(t.depth_fn())
                cap = float(t.capacity_fn())
            except Exception:
                depth, cap = 0.0, 0.0
            fill = depth / cap if cap > 0 else 0.0
            met.queue_depth.set(depth, queue=t.name)
            met.queue_capacity.set(cap, queue=t.name)
            queues[t.name] = {"depth": int(depth), "capacity": int(cap),
                              "fill": round(fill, 3)}
            if not t.advisory:
                worst = max(worst, fill)
        if worst >= SHEDDING_RATIO or self.recent_shed():
            level = "shedding"
        elif worst >= PRESSURED_RATIO:
            level = "pressured"
        else:
            level = "ok"
        met.level.set(("ok", "pressured", "shedding").index(level))
        return {"level": level, "worst_fill": round(worst, 3),
                "queues": queues}

    def level(self) -> str:
        return self.evaluate()["level"]


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


class DropOldestQueue:
    """Bounded queue that evicts the OLDEST item when full — for event
    streams where a slow consumer should lose history, not memory.
    put_nowait never fails; drops are counted via the controller (and
    an optional extra hook, `on_drop`)."""

    def __init__(self, maxsize: int, queue: str = "",
                 controller: OverloadController | None = None,
                 on_drop=None):
        self.maxsize = maxsize
        self.queue = queue
        self._controller = controller or CONTROLLER
        self._on_drop = on_drop
        self._d: collections.deque = collections.deque()
        self._not_empty = asyncio.Event()
        self.dropped = 0
        if queue:
            # every cataloged queue exports depth/capacity, not just
            # shed — registration replaces by name, so with several
            # instances (one per ws client) monitoring tracks the
            # latest. Advisory: a drop-oldest queue legitimately sits
            # full under a slow consumer; only its shed events drive
            # the overload level.
            self._controller.register(queue, self.qsize, maxsize,
                                      advisory=True, owner=self)

    def qsize(self) -> int:
        return len(self._d)

    def empty(self) -> bool:
        return not self._d

    def put_nowait(self, item) -> None:
        if len(self._d) >= self.maxsize:
            self._d.popleft()
            self.dropped += 1
            if self.queue:
                self._controller.shed(self.queue, advisory=True)
            if self._on_drop is not None:
                self._on_drop()
        self._d.append(item)
        self._not_empty.set()

    def close(self) -> None:
        """Drop the controller registration (and with it the strong
        reference keeping this queue alive) — a closed client's queue
        must not keep exporting stale depth. Owner-checked: a newer
        same-name queue's registration is left untouched."""
        if self.queue:
            self._controller.unregister(self.queue, owner=self)

    async def put(self, item) -> None:  # Queue-compatible signature
        self.put_nowait(item)

    async def get(self):
        while True:
            if self._d:
                return self._d.popleft()
            self._not_empty.clear()
            await self._not_empty.wait()

    def get_nowait(self):
        if not self._d:
            raise asyncio.QueueEmpty
        return self._d.popleft()


@dataclass
class SlowPeerPolicy:
    """Escalation thresholds for the p2p slow-peer monitor. Strikes
    are consecutive scan intervals with pending_send_bytes at or above
    the high-water mark; one healthy scan clears them."""

    pending_bytes_hiwater: int = 1 << 20   # 1 MiB of unsent backlog
    skip_strikes: int = 2                  # -> pause tx gossip
    demote_strikes: int = 4                # -> pause bulk data gossip
    disconnect_strikes: int = 8            # -> drop (non-persistent)


class SlowPeerTracker:
    """Pure bookkeeping behind Switch._scan_slow_peers: feed one
    observation per peer per scan, get back the escalation TRANSITION
    to act on (None when the level is unchanged).

    Levels: 0 healthy, 1 skip (tx gossip paused), 2 demote (bulk data
    gossip paused too; votes/state keep flowing — a slow peer must
    still count toward consensus). Persistent peers never pass level
    2: operators pinned them on purpose, so eviction is not ours to
    decide — they park at demote until they drain."""

    LEVEL_OK, LEVEL_SKIP, LEVEL_DEMOTE = 0, 1, 2

    def __init__(self, policy: SlowPeerPolicy | None = None):
        self.policy = policy or SlowPeerPolicy()
        self._strikes: dict[str, int] = {}
        self._level: dict[str, int] = {}

    def level(self, peer_id: str) -> int:
        return self._level.get(peer_id, 0)

    def forget(self, peer_id: str) -> None:
        self._strikes.pop(peer_id, None)
        self._level.pop(peer_id, None)

    def observe(self, peer_id: str, pending_bytes: int,
                persistent: bool) -> str | None:
        """Returns "skip" | "demote" | "disconnect" | "recover" on a
        level transition, None otherwise. A "disconnect" implies the
        caller removes the peer (and its state here is forgotten)."""
        p = self.policy
        if pending_bytes < p.pending_bytes_hiwater:
            self._strikes[peer_id] = 0
            if self._level.get(peer_id, 0) > 0:
                self._level[peer_id] = 0
                return "recover"
            return None
        strikes = self._strikes.get(peer_id, 0) + 1
        self._strikes[peer_id] = strikes
        cur = self._level.get(peer_id, 0)
        if strikes >= p.disconnect_strikes and not persistent:
            self.forget(peer_id)
            return "disconnect"
        if strikes >= p.demote_strikes and cur < self.LEVEL_DEMOTE:
            self._level[peer_id] = self.LEVEL_DEMOTE
            return "demote"
        if strikes >= p.skip_strikes and cur < self.LEVEL_SKIP:
            self._level[peer_id] = self.LEVEL_SKIP
            return "skip"
        return None
