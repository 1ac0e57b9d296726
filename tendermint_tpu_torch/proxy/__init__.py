"""proxy.AppConns — four logical ABCI connections to one app
(reference: proxy/__init__.py; Go proxy/app_conn.go:15-56,
proxy/multi_app_conn.go).

consensus / mempool / query / snapshot each get their own client so a
slow query can't head-of-line-block consensus. With LocalClients they
share one app lock.

Every connection's deliver() is wrapped with a latency observer: the
one choke point all client types share: it observes the reference's
`abci_connection_method_seconds{connection, method}` histogram.
"""

from __future__ import annotations

import time

from ..abci.client import Client, ClientCreator
from ..libs.metrics import abci_metrics
from ..libs.service import Service


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

    hist = abci_metrics().method_seconds
    inner = client.deliver
    keys: dict = {}

    async def timed_deliver(req):
        t = type(req)
        ob = keys.get(t)
        if ob is None:
            keys[t] = ob = hist.labels(connection=conn_name,
                                       method=_snake(t.__name__)).observe
        # chaos: the one choke point every client type shares — an
        # armed error here looks exactly like a dead app connection
        # (async variant: a delay stalls THIS call, not the event loop)
        await failpoints.hit_async("abci.deliver")
        t0 = time.perf_counter()
        try:
            return await inner(req)
        finally:
            ob(time.perf_counter() - t0)

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
