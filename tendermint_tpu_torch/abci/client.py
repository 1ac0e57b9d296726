"""ABCI clients (reference: abci/client.py; Go abci/client/).

LocalClient wraps an in-process Application behind a per-connection
asyncio.Lock (Go local_client.go's mutex). SocketClient speaks the
varint-length-framed message protocol to an out-of-process app and
pipelines requests: callers get futures resolved in strict FIFO order
by the response reader (Go socket_client.go:36,128,167). ClientCreator
hands proxy.AppConns its four clients. The gRPC transport is not ported
(ROADMAP Queue A item 9): a ClientCreator given a gRPC address raises.

Reconnects are counted in the reference's
``abci_client_reconnects_total`` by result ("ok", "failed").
"""

from __future__ import annotations

import asyncio
import logging

from ..encoding.proto import encode_varint
from ..libs.net import jittered_backoff
from ..libs.service import Service
from . import types as t

logger = logging.getLogger("abci.client")

def _count_reconnect(result: str) -> None:
    from ..libs.metrics import abci_metrics

    abci_metrics().client_reconnects.inc(result=result)


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


# --- socket framing: varint length prefix + JSON message ---------------------


def write_frame(writer: asyncio.StreamWriter, msg) -> None:
    data = t.encode_msg(msg)
    writer.write(encode_varint(len(data)) + data)


async def read_frame(reader: asyncio.StreamReader):
    # read varint byte-by-byte, then the payload
    ln = shift = 0
    while True:
        b = await reader.readexactly(1)
        ln |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 35:
            raise ABCIClientError("frame length varint too long")
    if ln > 64 << 20:
        raise ABCIClientError("frame too large")
    return t.decode_msg(await reader.readexactly(ln))


class SocketClient(Client):
    """Pipelined socket client. Responses arrive strictly in request
    order, so a FIFO of futures pairs them back up.

    A lost connection no longer kills the client for good: in-flight
    requests fail fast (they may or may not have been executed — the
    caller's replay/handshake logic owns that ambiguity, so NOTHING is
    silently retried here), and a background task re-dials the app
    with capped jittered exponential backoff. Once the transport is
    back, new requests flow again — a restarted ABCI app server no
    longer requires restarting the node (reference behavior was to
    die with the connection)."""

    RECONNECT_BASE_S = 0.5
    RECONNECT_MAX_S = 15.0

    def __init__(self, host: str = "127.0.0.1", port: int = 26658,
                 unix_path: str | None = None):
        super().__init__(name="abci.SocketClient")
        self.host, self.port, self.unix_path = host, port, unix_path
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: asyncio.Queue[asyncio.Future] = asyncio.Queue()
        self._conn_err: Exception | None = None

    async def _connect(self) -> None:
        if self.unix_path:
            self._reader, self._writer = await asyncio.open_unix_connection(
                self.unix_path
            )
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )

    async def on_start(self) -> None:
        await self._connect()
        self.spawn(self._recv_loop(), name="abci-recv")

    async def on_stop(self) -> None:
        if self._writer is not None:
            self._writer.close()

    async def _recv_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                resp = await read_frame(self._reader)
                fut = await self._pending.get()
                if fut.done():  # caller gave up (e.g. wait_for timeout)
                    continue
                if isinstance(resp, t.ResponseException):
                    fut.set_exception(ABCIClientError(resp.error))
                else:
                    fut.set_result(resp)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._conn_err = e
            while not self._pending.empty():
                fut = self._pending.get_nowait()
                if not fut.done():
                    fut.set_exception(ABCIClientError(f"connection lost: {e}"))
            if self.is_running:
                self.spawn(self._reconnect_loop(), name="abci-reconnect")

    async def _reconnect_loop(self) -> None:
        attempt = 0
        while self.is_running:
            await asyncio.sleep(jittered_backoff(
                attempt, self.RECONNECT_BASE_S, self.RECONNECT_MAX_S))
            if not self.is_running:
                return
            attempt += 1
            try:
                if self._writer is not None:
                    self._writer.close()
                await self._connect()
            except (ConnectionError, OSError) as e:
                _count_reconnect("failed")
                logger.warning("ABCI app reconnect attempt %d failed: %s",
                            attempt, e)
                continue
            # any future that raced into the queue after the recv
            # loop's drain must not mispair with responses on the NEW
            # connection (the FIFO would be off by one forever)
            while not self._pending.empty():
                fut = self._pending.get_nowait()
                if not fut.done():
                    fut.set_exception(ABCIClientError(
                        "connection replaced during reconnect"))
            self._conn_err = None
            _count_reconnect("ok")
            logger.warning("ABCI app connection re-established after "
                        "%d attempts", attempt)
            self.spawn(self._recv_loop(), name="abci-recv")
            return

    async def deliver(self, req):
        if self._conn_err is not None:
            raise ABCIClientError(f"connection lost: {self._conn_err}")
        assert self._writer is not None, "client not started"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._pending.put(fut)
        write_frame(self._writer, req)
        await self._writer.drain()
        return await fut

    async def flush(self) -> None:
        await self.deliver(t.RequestFlush())

    def in_flight(self) -> int:
        return self._pending.qsize()


class ClientCreator:
    """Factory handed to proxy.AppConns: a local app, a socket address
    or a unix socket (Go proxy/client.go NewLocalClientCreator /
    NewRemoteClientCreator with transport "socket"). The gRPC transport
    is not ported: given `grpc_addr` it raises NotImplementedError."""

    def __init__(self, app: t.Application | None = None,
                 addr: tuple[str, int] | None = None,
                 unix_path: str | None = None,
                 grpc_addr: tuple[str, int] | None = None):
        if grpc_addr is not None:
            raise NotImplementedError(
                "the gRPC ABCI transport is not ported (ROADMAP Queue A "
                "item 9: no grpc package on the GPU machine); use "
                f"the socket transport, not {grpc_addr!r}")
        if app is None and addr is None and unix_path is None:
            raise ValueError("ClientCreator needs an app or an address")
        self.app = app
        self.addr = addr
        self.unix_path = unix_path
        self._lock = asyncio.Lock() if app is not None else None

    def new_client(self) -> Client:
        if self.app is not None:
            return LocalClient(self.app, self._lock)
        if self.unix_path is not None:
            return SocketClient(unix_path=self.unix_path)
        return SocketClient(self.addr[0], self.addr[1])
