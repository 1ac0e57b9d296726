"""State sync: bootstrap a fresh node from an application snapshot
instead of replaying the whole chain (reference: statesync/__init__.py;
Go statesync/).

Flow (Go syncer.go:141 SyncAny): discover snapshots from peers → rank
them → offer the best to the app over the snapshot ABCI conn → fetch
chunks from all peers that have the snapshot → apply → confirm the
restored app hash against a LIGHT-CLIENT-verified header → hand a
trusted sm.State to the node, which bootstraps its stores and drops
into fast sync for the tail."""

from .messages import (
    ChunkRequestMessage,
    ChunkResponseMessage,
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    decode_ss_msg,
    encode_ss_msg,
)
from .snapshots import SnapshotPool
from .stateprovider import LightClientStateProvider, StateProvider
from .syncer import StateSyncError, Syncer


def __getattr__(name: str):
    # The reactor is the only submodule that pulls in the p2p stack;
    # loading it lazily keeps the core (Syncer, SnapshotPool, messages)
    # importable without it, as in the reference.
    if name in ("StateSyncReactor", "SNAPSHOT_CHANNEL", "CHUNK_CHANNEL"):
        from . import reactor

        return getattr(reactor, name)
    raise AttributeError(name)


__all__ = [
    "StateSyncReactor", "SNAPSHOT_CHANNEL", "CHUNK_CHANNEL",
    "Syncer", "StateSyncError", "SnapshotPool",
    "StateProvider", "LightClientStateProvider",
    "SnapshotsRequestMessage", "SnapshotsResponseMessage",
    "ChunkRequestMessage", "ChunkResponseMessage",
    "encode_ss_msg", "decode_ss_msg",
]
