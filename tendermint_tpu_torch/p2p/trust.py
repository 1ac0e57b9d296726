"""EWMA peer trust metric (reference: p2p/trust.py; Go
p2p/trust/metric.go, design in the Go reference's ADR-006).

A PID-flavored score in [0, 1] per peer:
  trust = 0.4 * proportional + 0.6 * history + weighted-derivative
where proportional = good/(good+bad) for the current interval, history
is a faded-memories weighted average of past intervals (2^m intervals
compressed into m slots), and the derivative term only punishes
(gamma 0 on improvement, 1 on decline). A paused metric (disconnected
peer) freezes history until the next event.

The asyncio-native difference from the reference: no goroutine +
request channel per metric — `tick()` is driven by the owning store's
single interval task (TrustMetricStore), and all methods are plain
synchronous calls (the event loop serializes them)."""

from __future__ import annotations

import json
import math

from ..libs import clock

_PROPORTIONAL_WEIGHT = 0.4
_INTEGRAL_WEIGHT = 0.6
_HISTORY_DATA_WEIGHT = 0.8
_DERIVATIVE_GAMMA_UP = 0.0
_DERIVATIVE_GAMMA_DOWN = 1.0
_TRACKING_WINDOW_S = 14 * 24 * 3600.0
_INTERVAL_S = 60.0


def _interval_to_offset(interval: int) -> int:
    """2^m intervals live in m history slots: slot = floor(log2(i))."""
    return int(math.floor(math.log2(interval)))


class TrustMetric:
    def __init__(self, interval_s: float = _INTERVAL_S,
                 window_s: float = _TRACKING_WINDOW_S):
        self.interval_s = interval_s
        self.max_intervals = max(1, int(window_s / interval_s))
        self.history_max = _interval_to_offset(self.max_intervals) + 1
        self.num_intervals = 0
        self.history: list[float] = []
        self.history_weights: list[float] = []
        self.history_weight_sum = 0.0
        self.history_value = 1.0
        self.good = 0.0
        self.bad = 0.0
        self.paused = False

    # -- events --

    def _unpause(self) -> None:
        if self.paused:
            self.good = 0.0
            self.bad = 0.0
            self.paused = False

    def good_events(self, n: int = 1) -> None:
        self._unpause()
        self.good += n

    def bad_events(self, n: int = 1) -> None:
        self._unpause()
        self.bad += n

    def pause(self) -> None:
        self.paused = True

    # -- value --

    def _proportional(self) -> float:
        total = self.good + self.bad
        return self.good / total if total > 0 else 1.0

    def trust_value(self) -> float:
        p = _PROPORTIONAL_WEIGHT * self._proportional()
        i = _INTEGRAL_WEIGHT * self.history_value
        d = self._proportional() - self.history_value
        gamma = _DERIVATIVE_GAMMA_DOWN if d < 0 else _DERIVATIVE_GAMMA_UP
        return max(0.0, p + i + gamma * d)

    def trust_score(self) -> int:
        return int(math.floor(self.trust_value() * 100))

    # -- interval roll-over (driven by the store's ticker) --

    def tick(self) -> None:
        """reference NextTimeInterval: bank this interval, fade memory."""
        if self.paused:
            return
        self.history.append(self.trust_value())
        if len(self.history) > self.history_max:
            self.history = self.history[-self.history_max:]
        if self.num_intervals < self.max_intervals:
            self.num_intervals += 1
            w = _HISTORY_DATA_WEIGHT ** self.num_intervals
            self.history_weights.append(w)
            self.history_weight_sum += w
        self._update_faded_memory()
        self.history_value = self._calc_history_value()
        self.good = 0.0
        self.bad = 0.0

    def _update_faded_memory(self) -> None:
        size = len(self.history)
        if size < 2:
            return
        end = size - 1
        for count in range(1, size):
            i = end - count
            x = 2.0 ** count
            self.history[i] = (self.history[i] * (x - 1)
                               + self.history[i + 1]) / x

    def _faded_memory_value(self, interval: int) -> float:
        first = len(self.history) - 1
        if interval == 0:
            return self.history[first]
        return self.history[first - _interval_to_offset(interval)]

    def _calc_history_value(self) -> float:
        if not self.num_intervals:
            return 1.0
        hv = sum(
            self._faded_memory_value(i) * self.history_weights[i]
            for i in range(min(self.num_intervals, len(self.history_weights)))
        )
        return hv / self.history_weight_sum

    # -- persistence (reference MetricHistoryJSON) --

    def to_json(self) -> dict:
        return {"intervals": self.num_intervals, "history": self.history}

    def load_json(self, d: dict) -> None:
        self.num_intervals = min(int(d.get("intervals", 0)),
                                 self.max_intervals)
        hist = list(d.get("history", []))
        self.history = hist[-self.history_max:]
        self.history_weights = [
            _HISTORY_DATA_WEIGHT ** i
            for i in range(1, self.num_intervals + 1)
        ]
        self.history_weight_sum = sum(self.history_weights)
        if self.num_intervals:
            self.history_value = self._calc_history_value()


class TrustMetricStore:
    """Per-peer metrics + periodic interval ticking + persistence
    (reference: p2p/trust/store.go). `tick_all` is called by the owner
    (Switch or a node task) every interval; peers that disconnect get
    their metric paused, reconnects resume the same history."""

    def __init__(self, db=None, interval_s: float = _INTERVAL_S):
        self.metrics: dict[str, TrustMetric] = {}
        self.db = db
        self.interval_s = interval_s
        self._last_tick = clock.monotonic()
        if db is not None:
            raw = db.get(b"trusthistory")
            if raw:
                try:
                    for peer_id, hist in json.loads(raw).items():
                        m = TrustMetric(interval_s=interval_s)
                        m.load_json(hist)
                        m.pause()
                        self.metrics[peer_id] = m
                except (ValueError, KeyError):
                    pass

    def get_metric(self, peer_id: str) -> TrustMetric:
        m = self.metrics.get(peer_id)
        if m is None:
            m = TrustMetric(interval_s=self.interval_s)
            self.metrics[peer_id] = m
        return m

    def peer_disconnected(self, peer_id: str) -> None:
        m = self.metrics.get(peer_id)
        if m is not None:
            m.pause()

    def size(self) -> int:
        return len(self.metrics)

    def maybe_tick(self) -> None:
        """Roll intervals for every metric when the interval elapsed
        (call from any periodic loop; cheap no-op otherwise)."""
        now = clock.monotonic()
        while now - self._last_tick >= self.interval_s:
            self._last_tick += self.interval_s
            for m in self.metrics.values():
                m.tick()

    def save(self) -> None:
        if self.db is None:
            return
        self.db.set(b"trusthistory", json.dumps({
            pid: m.to_json() for pid, m in self.metrics.items()
        }).encode())
