"""ABCI socket server for out-of-process apps (reference:
abci/server.py; Go abci/server/socket_server.go).

One handler task per accepted connection; requests on a connection are
dispatched to the app serially under a server-wide lock (the reference
guards the app with one mutex across its 4 logical connections)."""

from __future__ import annotations

import asyncio

from ..libs.service import Service
from . import types as t
from .client import read_frame, write_frame


class SocketServer(Service):
    def __init__(self, app: t.Application, host: str = "127.0.0.1",
                 port: int = 26658, unix_path: str | None = None):
        super().__init__(name="abci.SocketServer")
        self.app = app
        self.host, self.port, self.unix_path = host, port, unix_path
        self._server: asyncio.AbstractServer | None = None
        self._app_lock = asyncio.Lock()

    async def on_start(self) -> None:
        if self.unix_path:
            self._server = await asyncio.start_unix_server(
                self._handle, self.unix_path
            )
        else:
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port
            )
            # pick up the OS-assigned port when port=0 was requested
            self.port = self._server.sockets[0].getsockname()[1]

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await read_frame(reader)
                resp = await self._dispatch(req)
                write_frame(writer, resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, req):
        if isinstance(req, t.RequestEcho):
            return t.ResponseEcho(req.message)
        if isinstance(req, t.RequestFlush):
            return t.ResponseFlush()
        method = t.HANDLERS.get(type(req))
        if method is None:
            return t.ResponseException(f"unknown request {type(req).__name__}")
        try:
            async with self._app_lock:
                return getattr(self.app, method)(req)
        except Exception as e:  # app bug -> error frame, not dead conn
            self.logger.error("app %s failed: %r", method, e)
            return t.ResponseException(repr(e))
