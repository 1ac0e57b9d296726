"""Timeout ticker (reference: consensus/ticker.py; Go
consensus/ticker.go:31,94).

One in-flight timer; scheduling a new timeout for a later (h, r, step)
cancels the old one (the Go reference drains its timer channel). Fired
timeouts land on an asyncio queue the consensus loop selects on."""

from __future__ import annotations

import asyncio

from .wal import TimeoutInfo


class TimeoutTicker:
    def __init__(self):
        self.queue: asyncio.Queue[TimeoutInfo] = asyncio.Queue()
        self._timer: asyncio.TimerHandle | None = None
        self._current: TimeoutInfo | None = None

    def schedule(self, ti: TimeoutInfo) -> None:
        """Replace the active timer iff ti is for a later (h, r, step)
        — or unconditionally when no timer is active."""
        cur = self._current
        if cur is not None and self._timer is not None:
            if (ti.height, ti.round, ti.step) < (cur.height, cur.round, cur.step):
                return  # stale schedule, keep the newer timer
            self._timer.cancel()
        self._current = ti
        loop = asyncio.get_running_loop()
        self._timer = loop.call_later(ti.duration_s, self._fire, ti)

    def _fire(self, ti: TimeoutInfo) -> None:
        if self._current is ti:
            self._current = None
            self._timer = None
        self.queue.put_nowait(ti)

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            self._current = None
