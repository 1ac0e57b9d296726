"""P2P stack — the distributed communication backend (reference: p2p/;
Go p2p/).

TCP + Station-to-Station authenticated encryption (secret_connection),
one connection per peer multiplexed into priority-weighted channels
(connection), a listener/dialer transport exchanging NodeInfo
(transport), and the Switch owning peer lifecycle and reactor routing
(switch). Peer discovery (the PEX reactor and address book, pex/) and
UPnP are not ported yet.
"""

from .key import NodeKey, node_id_from_pubkey
from .node_info import NodeInfo, ProtocolVersion
from .switch import ChannelDescriptor, Reactor, Switch

__all__ = [
    "NodeKey", "node_id_from_pubkey", "NodeInfo", "ProtocolVersion",
    "Switch", "Reactor", "ChannelDescriptor",
]
