"""SimTransport: the p2p Transport surface over SimNetwork (reference:
tendermint_tpu/sim/transport.py).

Interposes at the exact seam the Switch consumes — listen / accept /
dial / close / listen_addr — so the whole peer stack above it
(Peer, MConnection packetization, channel priorities, reactors,
slow-peer escalation, behaviour reports) is the PRODUCTION code, not
a test double. What it removes is below the seam: sockets, the
secret-connection crypto handshake, and wall-clock I/O. Node identity
still travels as NodeInfo and is checked for id match + compatibility
like Transport._upgrade; authenticity is free in-process (there is no
wire for a MITM to sit on).
"""

from __future__ import annotations

import asyncio

from ..p2p.transport import HandshakeError
from .network import SimConn, SimNetError, SimNetwork


class SimTransport:
    def __init__(self, node_key, node_info_fn, network: SimNetwork,
                 host: str, port: int = 26656):
        self.node_key = node_key
        self.node_info_fn = node_info_fn
        self.network = network
        self.host = host
        self.port = port
        self._accept_queue: asyncio.Queue = asyncio.Queue(64)
        self._server = None  # truthy once listening (Transport parity)

    @property
    def listen_addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def listen(self, host: str | None = None,
                     port: int | None = None) -> None:
        # host/port args accepted for Transport signature parity; the
        # sim address is fixed at construction (it IS the identity the
        # network model keys links and partitions on).
        self.network.listen(self.host, self.port, self)
        self._server = (self.host, self.port)

    async def accept(self) -> tuple[SimConn, object, str]:
        return await self._accept_queue.get()

    async def dial(self, host: str, port: int) -> tuple[SimConn, object]:
        conn_c, conn_s = self.network.connect(self.host, host, int(port))
        # one virtual RTT for SYN + NodeInfo swap
        rtt = 2.0 * self.network.link(self.host, host).one_way_s()
        if rtt > 0:
            await asyncio.sleep(rtt)
        target = self.network.listeners.get((host, int(port)))
        if target is None or conn_c.closed:
            # listener died (churn) or a partition landed mid-handshake
            conn_c.reset()
            conn_s.reset()
            raise SimNetError(f"sim dial {host}:{port}: peer went away "
                              "during handshake")
        mine = self.node_info_fn()
        theirs = target.node_info_fn()
        theirs.validate_basic()
        err = mine.compatible_with(theirs) or theirs.compatible_with(mine)
        if err is not None:
            conn_c.reset()
            conn_s.reset()
            raise HandshakeError(err)
        try:
            target._accept_queue.put_nowait(
                (conn_s, mine, f"{self.host}:{self.port}"))
        except asyncio.QueueFull:
            conn_c.reset()
            conn_s.reset()
            raise SimNetError(
                f"sim dial {host}:{port}: accept queue full") from None
        return conn_c, theirs

    async def close(self) -> None:
        if self._server is not None:
            self.network.unlisten(self.host, self.port)
            self._server = None
        while True:
            try:
                conn, _, _ = self._accept_queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            conn.reset()
