"""ABCI clients (reference: abci/client.py; Go abci/client/).

LocalClient wraps an in-process Application behind a per-connection
asyncio.Lock (Go local_client.go's mutex); ClientCreator hands
proxy.AppConns its four clients. The reference's SocketClient (a
varint-framed, pipelined socket transport) and GRPCClient wait for a
later slice of the port (ROADMAP Queue A item 7): a ClientCreator given
an address raises.
"""

from __future__ import annotations

import asyncio

from ..libs.service import Service
from . import types as t


class ABCIClientError(Exception):
    pass


class Client(Service):
    """Interface: deliver(req) -> response; flush() drains the pipe."""

    async def deliver(self, req):
        raise NotImplementedError

    async def flush(self) -> None:
        pass

    # typed sugar
    async def echo(self, msg: str) -> t.ResponseEcho:
        return await self.deliver(t.RequestEcho(msg))

    async def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return await self.deliver(req)

    async def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        return await self.deliver(req)

    async def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        return await self.deliver(req)

    async def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        return await self.deliver(req)

    async def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        return await self.deliver(req)

    async def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        return await self.deliver(req)

    async def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return await self.deliver(req)

    async def commit(self) -> t.ResponseCommit:
        return await self.deliver(t.RequestCommit())

    async def list_snapshots(self) -> t.ResponseListSnapshots:
        return await self.deliver(t.RequestListSnapshots())

    async def offer_snapshot(
        self, req: t.RequestOfferSnapshot
    ) -> t.ResponseOfferSnapshot:
        return await self.deliver(req)

    async def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        return await self.deliver(req)

    async def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        return await self.deliver(req)

    def submit(self, req) -> asyncio.Task:
        """Fire a request without awaiting — the async-pipelined
        DeliverTx path (Go socket_client.go DeliverTxAsync)."""
        return asyncio.get_running_loop().create_task(self.deliver(req))

    def in_flight(self) -> int:
        """Requests accepted but not yet answered on this connection —
        the admission-control window the mempool's busy check reads
        (mempool/clist_mempool.py): a saturated app must shed new
        CheckTx work, not queue it unboundedly."""
        return 0


class LocalClient(Client):
    """In-process client; one lock per connection serializes app calls
    (the app itself may be shared by several LocalClients, matching the
    Go reference where one mutex guards the app across connections)."""

    def __init__(self, app: t.Application, lock: asyncio.Lock | None = None):
        super().__init__(name="abci.LocalClient")
        self.app = app
        self._lock = lock or asyncio.Lock()
        self._in_flight = 0

    async def deliver(self, req):
        if isinstance(req, t.RequestEcho):
            return t.ResponseEcho(req.message)
        if isinstance(req, t.RequestFlush):
            return t.ResponseFlush()
        method = t.HANDLERS[type(req)]
        # waiting on the shared app lock counts as in flight: that IS
        # the saturated-app condition admission control sheds on
        self._in_flight += 1
        try:
            async with self._lock:
                return getattr(self.app, method)(req)
        finally:
            self._in_flight -= 1

    def in_flight(self) -> int:
        return self._in_flight


class ClientCreator:
    """Factory handed to proxy.AppConns (Go proxy/client.go
    NewLocalClientCreator): every client shares the app and one lock.
    Only an in-process app is ported: given no app (an address, a unix
    socket or a gRPC address in the reference), it raises
    NotImplementedError."""

    def __init__(self, app: t.Application | None = None,
                 addr: tuple[str, int] | None = None,
                 unix_path: str | None = None,
                 grpc_addr: tuple[str, int] | None = None):
        if app is None:
            raise NotImplementedError(
                "the socket and gRPC ABCI transports are not ported yet "
                "(ROADMAP Queue A item 7); pass an in-process app, not "
                f"{addr or unix_path or grpc_addr!r}")
        self.app = app
        self._lock = asyncio.Lock()

    def new_client(self) -> Client:
        return LocalClient(self.app, self._lock)
