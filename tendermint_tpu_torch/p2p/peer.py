"""Peer: a connected remote node (reference: p2p/peer.py; Go
p2p/peer.go).

Wraps the MConnection with identity (NodeInfo), reactor-visible
send/try_send by channel id, and a small kv store reactors use to hang
per-peer state on (e.g. the consensus reactor's PeerState).
"""

from __future__ import annotations

from .conn.connection import MConnConfig, MConnection
from .conn.secret_connection import SecretConnection
from .node_info import NodeInfo


class Peer:
    def __init__(self, conn: SecretConnection, node_info: NodeInfo,
                 channels, on_receive, on_error,
                 outbound: bool, persistent: bool = False,
                 socket_addr: str = "", mconn_config: MConnConfig | None = None,
                 on_fault=None):
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr      # actual remote "host:port"
        self._kv: dict[str, object] = {}
        # Slow-peer escalation level (set by Switch._scan_slow_peers):
        # 0 healthy, 1 skip tx gossip, 2 also skip bulk data gossip
        # (votes/state keep flowing). Reactors consult it read-only.
        self.slow_level = 0
        self.mconn = MConnection(conn, channels,
                                 on_receive=lambda ch, msg: on_receive(self, ch, msg),
                                 on_error=lambda e: on_error(self, e),
                                 config=mconn_config,
                                 on_fault=on_fault)

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def is_persistent(self) -> bool:
        return self.persistent

    async def start(self) -> None:
        await self.mconn.start()

    async def stop(self) -> None:
        if self.mconn.is_running:
            await self.mconn.stop()

    async def send(self, chan_id: int, msg: bytes) -> bool:
        return await self.mconn.send(chan_id, msg)

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        return self.mconn.try_send(chan_id, msg)

    def pending_send_bytes(self) -> int:
        return self.mconn.pending_send_bytes()

    def send_rate(self) -> float:
        return self.mconn.send_rate()

    def get(self, key: str):
        return self._kv.get(key)

    def set(self, key: str, value) -> None:
        self._kv[key] = value

    def __repr__(self) -> str:
        arrow = "out" if self.outbound else "in"
        return f"Peer({self.id[:12]}…,{arrow})"
