"""Async service lifecycle (reference: libs/service.py; Go
libs/service/service.go).

The reference's BaseService gives every component uniform
Start/Stop/Reset semantics with idempotence guarantees. Here services
are asyncio-native: on_start may spawn tasks via ``spawn`` which are
cancelled and awaited on stop.
"""

from __future__ import annotations

import asyncio
import logging


class ServiceError(Exception):
    pass


class AlreadyStarted(ServiceError):
    pass


class NotStarted(ServiceError):
    pass


class Service:
    """Base class with idempotent start/stop and task supervision."""

    def __init__(self, name: str | None = None, logger: logging.Logger | None = None):
        self.name = name or type(self).__name__
        self.logger = logger or logging.getLogger(self.name)
        self._started = False
        self._stopped = False
        self._tasks: list[asyncio.Task] = []

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    async def start(self) -> None:
        if self._started:
            raise AlreadyStarted(f"{self.name} already started")
        self._started = True
        self._stopped = False
        self.logger.debug("starting %s", self.name)
        await self.on_start()

    async def stop(self) -> None:
        if not self._started:
            raise NotStarted(f"{self.name} not started")
        if self._stopped:
            return
        self._stopped = True
        self.logger.debug("stopping %s", self.name)
        await self.on_stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()

    async def restart(self) -> None:
        if self._started and not self._stopped:
            await self.stop()
        self._started = False
        await self.start()

    def spawn(self, coro, name: str | None = None) -> asyncio.Task:
        """Run a coroutine under this service's supervision."""
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.append(task)
        task.add_done_callback(self._on_task_done)
        return task

    def _on_task_done(self, task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            self.logger.error("task %s crashed: %r", task.get_name(), exc)
            self.on_task_crash(task, exc)

    def on_task_crash(self, task: asyncio.Task, exc: BaseException) -> None:
        """Override for crash policy (default: log only)."""

    async def on_start(self) -> None:  # pragma: no cover - interface
        pass

    async def on_stop(self) -> None:  # pragma: no cover - interface
        pass

    async def wait(self) -> None:
        """Block until all supervised tasks finish."""
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
