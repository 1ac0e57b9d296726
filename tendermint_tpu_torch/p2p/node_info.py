"""NodeInfo: the identity/capability record exchanged at handshake
(reference: p2p/node_info.py; Go p2p/node_info.go).

Compatibility: same block protocol version, same network (chain id),
at least one common channel.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class ProtocolVersion:
    p2p: int = 8
    block: int = 11
    app: int = 0


@dataclass
class NodeInfo:
    node_id: str = ""
    listen_addr: str = ""            # "host:port" the peer accepts on
    network: str = ""                # chain id
    version: str = "0.1.0"
    channels: bytes = b""            # channel ids this node serves
    moniker: str = ""
    protocol_version: ProtocolVersion = field(default_factory=ProtocolVersion)
    tx_index: str = "on"
    rpc_address: str = ""

    def validate_basic(self) -> None:
        if not self.node_id or len(bytes.fromhex(self.node_id)) != 20:
            raise ValueError("invalid node id")
        if len(self.channels) > 16:
            raise ValueError("too many channels")
        if len(self.moniker) > 64:
            raise ValueError("moniker too long")

    def compatible_with(self, other: "NodeInfo") -> str | None:
        """Returns an error string, or None if compatible
        (reference: node_info.go CompatibleWith)."""
        if self.protocol_version.block != other.protocol_version.block:
            return (f"block version mismatch: {self.protocol_version.block} "
                    f"vs {other.protocol_version.block}")
        if self.network != other.network:
            return f"network mismatch: {self.network!r} vs {other.network!r}"
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                return "no common channels"
        return None

    def to_bytes(self) -> bytes:
        return json.dumps({
            "node_id": self.node_id,
            "listen_addr": self.listen_addr,
            "network": self.network,
            "version": self.version,
            "channels": self.channels.hex(),
            "moniker": self.moniker,
            "protocol_version": [self.protocol_version.p2p,
                                 self.protocol_version.block,
                                 self.protocol_version.app],
            "tx_index": self.tx_index,
            "rpc_address": self.rpc_address,
        }, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "NodeInfo":
        d = json.loads(data)
        pv = d.get("protocol_version", [8, 11, 0])
        return cls(
            node_id=d.get("node_id", ""),
            listen_addr=d.get("listen_addr", ""),
            network=d.get("network", ""),
            version=d.get("version", ""),
            channels=bytes.fromhex(d.get("channels", "")),
            moniker=d.get("moniker", ""),
            protocol_version=ProtocolVersion(*pv),
            tx_index=d.get("tx_index", "on"),
            rpc_address=d.get("rpc_address", ""),
        )
