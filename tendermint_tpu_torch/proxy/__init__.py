"""proxy.AppConns — four logical ABCI connections to one app
(reference: proxy/__init__.py; Go proxy/app_conn.go:15-56,
proxy/multi_app_conn.go).

consensus / mempool / query / snapshot each get their own client so a
slow query can't head-of-line-block consensus. With LocalClients they
share one app lock.

Every connection's deliver() is wrapped with a latency observer: the
one choke point all client types share. The reference observes it into
its `abci_connection_method_seconds{connection, method}` histogram; the
port keeps the calls and their summed seconds a (connection, method)
in ``METRICS``, a plain dict (crypto/batch.py's convention).
"""

from __future__ import annotations

import time

from ..abci.client import Client, ClientCreator
from ..libs.service import Service

# (connection, method) -> calls, and -> summed seconds
METRICS: dict = {"method_calls": {}, "method_seconds": {}}


def _snake(req_type_name: str) -> str:
    """RequestCheckTx -> check_tx."""
    name = req_type_name.removeprefix("Request")
    return "".join(
        ("_" + c.lower()) if c.isupper() and i else c.lower()
        for i, c in enumerate(name)
    )


def instrument_client(client: Client, conn_name: str) -> Client:
    """Wrap client.deliver with a per-(connection, method) latency
    observer. Works on any Client subclass because `submit` and the
    typed sugar all funnel through deliver(). The key is cached per
    request TYPE, so the per-call cost on the CheckTx / DeliverTx hot
    path is a dict lookup."""
    from ..libs import failpoints

    calls, seconds = METRICS["method_calls"], METRICS["method_seconds"]
    inner = client.deliver
    keys: dict[type, tuple[str, str]] = {}

    async def timed_deliver(req):
        t = type(req)
        key = keys.get(t)
        if key is None:
            keys[t] = key = (conn_name, _snake(t.__name__))
        # chaos: the one choke point every client type shares — an
        # armed error here looks exactly like a dead app connection
        # (async variant: a delay stalls THIS call, not the event loop)
        await failpoints.hit_async("abci.deliver")
        t0 = time.perf_counter()
        try:
            return await inner(req)
        finally:
            calls[key] = calls.get(key, 0) + 1
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0

    client.deliver = timed_deliver
    return client


class AppConns(Service):
    def __init__(self, creator: ClientCreator):
        super().__init__(name="proxy.AppConns")
        self.consensus: Client = instrument_client(
            creator.new_client(), "consensus")
        self.mempool: Client = instrument_client(
            creator.new_client(), "mempool")
        self.query: Client = instrument_client(
            creator.new_client(), "query")
        self.snapshot: Client = instrument_client(
            creator.new_client(), "snapshot")

    def _all(self) -> list[Client]:
        return [self.consensus, self.mempool, self.query, self.snapshot]

    async def on_start(self) -> None:
        for c in self._all():
            await c.start()

    async def on_stop(self) -> None:
        for c in self._all():
            if c.is_running:
                await c.stop()
