"""TCP transport: listen/dial, secret-connection upgrade, NodeInfo
handshake (reference: p2p/transport.py; Go p2p/transport_mconn.go:74).

Produces (SecretConnection, NodeInfo) pairs the Switch turns into
Peers. Dial and handshake are bounded by timeouts; connection filters
(duplicate ID/IP) live in the Switch.
"""

from __future__ import annotations

import asyncio

from .conn.secret_connection import SecretConnection, make_secret_connection
from .key import NodeKey, node_id_from_pubkey
from .node_info import NodeInfo


class TransportError(Exception):
    pass


class HandshakeError(TransportError):
    pass


class Transport:
    def __init__(self, node_key: NodeKey, node_info_fn,
                 handshake_timeout: float = 20.0,
                 dial_timeout: float = 3.0,
                 max_pending_handshakes: int = 64,
                 conn_filters: list | None = None):
        from .conn_set import ConnSet

        # Pre-auth DoS bound: an attacker stalling mid-handshake holds a
        # slot for at most handshake_timeout; beyond the cap new dialers
        # are refused at accept, before any crypto work.
        self._handshake_slots = asyncio.Semaphore(max_pending_handshakes)
        self.node_key = node_key
        # node_info is late-bound: listen addr isn't known until Listen
        self.node_info_fn = node_info_fn
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        # Inbound conn filters (reference transport_mconn.go filters +
        # node.go:422-478 wiring): each is filter(conn_set, ip) and
        # raises to refuse, BEFORE the handshake spends crypto.
        self.conn_filters = list(conn_filters or [])
        self.conn_set = ConnSet()
        self._server: asyncio.AbstractServer | None = None
        self._accept_queue: asyncio.Queue = asyncio.Queue(32)

    @property
    def listen_addr(self) -> str:
        assert self._server is not None
        sock = self._server.sockets[0]
        host, port = sock.getsockname()[:2]
        return f"{host}:{port}"

    async def listen(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._on_accept, host, port)

    async def _on_accept(self, reader, writer) -> None:
        if self._handshake_slots.locked():
            writer.close()
            return
        peername = writer.get_extra_info("peername")
        ip = peername[0] if peername else ""
        for f in self.conn_filters:
            try:
                f(self.conn_set, ip)
            except Exception:
                writer.close()
                return
        # Track at FILTER time (keyed on the raw socket), as the
        # reference does (transport.go filterConn → conns.Set): two
        # simultaneous accepts from one IP must not both slip past
        # the dup-IP check while neither is handshaken yet.
        self.conn_set.add(writer, ip)
        try:
            async with self._handshake_slots:
                conn, ni = await asyncio.wait_for(
                    self._upgrade(reader, writer), self.handshake_timeout)
        except Exception:
            self.conn_set.remove(writer)
            writer.close()
            return
        # Untrack on close, wherever the close happens (peer stop,
        # queue shed, switch rejection) — conn.close() is the funnel.
        orig_close = conn.close

        def _close_untracked():
            self.conn_set.remove(writer)
            orig_close()

        conn.close = _close_untracked
        try:
            # Never block holding an authenticated socket: if the Switch
            # isn't draining the queue, shed the newest connection.
            sock_addr = f"{ip}:{peername[1]}" if peername else ""
            self._accept_queue.put_nowait((conn, ni, sock_addr))
        except asyncio.QueueFull:
            conn.close()

    async def accept(self) -> tuple[SecretConnection, NodeInfo, str]:
        """Next authenticated inbound (conn, node_info, remote_addr) —
        the remote addr feeds peer filters and peer bookkeeping."""
        return await self._accept_queue.get()

    async def dial(self, host: str, port: int) -> tuple[SecretConnection, NodeInfo]:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), self.dial_timeout)
        try:
            return await asyncio.wait_for(
                self._upgrade(reader, writer), self.handshake_timeout)
        except Exception:
            writer.close()
            raise

    async def _upgrade(self, reader, writer) -> tuple[SecretConnection, NodeInfo]:
        """Secret-conn handshake, then swap NodeInfo; verify the claimed
        node id matches the authenticated pubkey (transport_mconn.go:533)."""
        conn = await make_secret_connection(reader, writer,
                                            self.node_key.priv_key)
        await conn.write_msg(self.node_info_fn().to_bytes())
        their = NodeInfo.from_bytes(await conn.read_msg())
        their.validate_basic()
        authed_id = node_id_from_pubkey(conn.remote_pubkey)
        if their.node_id != authed_id:
            raise HandshakeError(
                f"peer claims id {their.node_id} but key authenticates "
                f"as {authed_id}")
        err = self.node_info_fn().compatible_with(their)
        if err is not None:
            raise HandshakeError(err)
        return conn, their

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # Drain queued-but-never-accepted authenticated conns: their
        # sockets (and ConnSet entries, via the close funnel) would
        # otherwise leak for the life of the process.
        while True:
            try:
                conn, _, _ = self._accept_queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            conn.close()
