"""Concurrent linked list with waitable iteration (reference:
libs/clist.py; Go libs/clist/clist.go).

The reference's CList lets N reader goroutines walk a list while a
writer appends/removes: each element keeps next/prev pointers plus
"next-ready" wait channels, and removal tombstones the element so a
parked iterator can skip over it. Consumers: the mempool's per-peer
broadcast routines and the evidence pool's gossip routine.

Here the same contract is asyncio-native: ``front_wait``/``next_wait``
park on an asyncio.Event that the writer sets on push_back. Removal
marks the element and detaches it, but a parked iterator holding the
element can still follow its (frozen) next pointer forward.
"""

from __future__ import annotations

import asyncio
from typing import Any


class CElement:
    __slots__ = ("value", "_next", "_prev", "removed", "_next_ev")

    def __init__(self, value: Any):
        self.value = value
        self._next: CElement | None = None
        self._prev: CElement | None = None
        self.removed = False
        self._next_ev = asyncio.Event()

    def next(self) -> "CElement | None":
        return self._next

    def prev(self) -> "CElement | None":
        return self._prev

    async def next_wait(self) -> "CElement | None":
        """Wait until this element has a successor or is removed.
        Returns the successor (None if this element was removed while
        parked — caller restarts from front)."""
        while self._next is None and not self.removed:
            self._next_ev.clear()
            await self._next_ev.wait()
        return self._next


class CList:
    def __init__(self):
        self._head: CElement | None = None
        self._tail: CElement | None = None
        self._len = 0
        self._front_ev = asyncio.Event()

    def __len__(self) -> int:
        return self._len

    def front(self) -> CElement | None:
        return self._head

    def back(self) -> CElement | None:
        return self._tail

    async def front_wait(self) -> CElement:
        while self._head is None:
            self._front_ev.clear()
            await self._front_ev.wait()
        return self._head

    def push_back(self, value: Any) -> CElement:
        e = CElement(value)
        if self._tail is None:
            self._head = self._tail = e
            self._front_ev.set()
        else:
            e._prev = self._tail
            self._tail._next = e
            self._tail._next_ev.set()
            self._tail = e
        self._len += 1
        return e

    def remove(self, e: CElement) -> Any:
        if e.removed:
            return e.value
        e.removed = True
        if e._prev is not None:
            e._prev._next = e._next
        else:
            self._head = e._next
        if e._next is not None:
            e._next._prev = e._prev
        else:
            self._tail = e._prev
        self._len -= 1
        # wake iterators parked on this element so they can re-anchor;
        # e._next stays frozen so a holder can walk forward.
        e._next_ev.set()
        if self._head is None:
            self._front_ev.clear()
        return e.value

    def __iter__(self):
        e = self._head
        while e is not None:
            if not e.removed:
                yield e.value
            e = e._next
