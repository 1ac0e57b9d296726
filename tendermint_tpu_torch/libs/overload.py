"""Coordinated backpressure and load shedding (reference:
libs/overload.py), trimmed to the aggregate controller.

Every queue that can grow under external input is bounded, counts what
it sheds, and registers with the process-global ``CONTROLLER``, which
aggregates saturation into one ok/pressured/shedding level. The port's
two tracked queues so far are the vote scheduler's buffer
(``consensus.vote_buf``, consensus/state.py) and the light verify
collector's backlog (``light.pending_verify``, light/serving.py).

The reference also exports depth/capacity gauges and a shed counter
through its metrics library; the port keeps the shed counts in
``OverloadController.sheds``, a plain dict (crypto/batch.py METRICS
convention). PriorityFunnel, DropOldestQueue and the slow-peer
bookkeeping come with the p2p and mempool ports, and with them the
reference's advisory queues and sheds (reported, not driving the
level) and its configurable shed window: neither tracked queue here is
advisory.
"""

from __future__ import annotations

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

    def shed(self, queue: str, n: int = 1) -> None:
        """Record `n` items dropped by policy from `queue`."""
        self.sheds[queue] = self.sheds.get(queue, 0) + n
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
