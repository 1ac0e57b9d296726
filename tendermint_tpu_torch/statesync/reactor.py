"""State-sync reactor, channels 0x60 (snapshots) / 0x61 (chunks)
(reference: statesync/reactor.py; Go statesync/reactor.go:56).

Server side (always on): answers SnapshotsRequest from the app's
ListSnapshots and ChunkRequest from LoadSnapshotChunk. Client side
(when the node boots with state_sync enabled): feeds discovered
snapshots/chunks into the Syncer and runs sync().

The join sequence of a node (reference node/__init__.py:539-549
_run_state_sync): ``state, commit = await reactor.sync()``, then
``state_store.bootstrap(state)``, ``block_store.save_seen_commit(
state.last_block_height, commit)`` and
``BlockchainReactor.switch_to_fast_sync(state)``.

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError met in ``receive`` reaches
``Switch.halt`` (the switch's ``_on_peer_receive``), and ``sync``
re-raises one from the syncer (syncer.py)."""

from __future__ import annotations

import logging

from ..abci import types as abci
from ..libs import failpoints
from ..p2p.conn.connection import ChannelDescriptor
from ..p2p.switch import Reactor
from .messages import (
    MAX_MSG_SIZE,
    ChunkRequestMessage,
    ChunkResponseMessage,
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    decode_ss_msg,
    encode_ss_msg,
)
from .snapshots import Snapshot
from ..libs.metrics import consensus_metrics, statesync_metrics
from .syncer import Syncer, count

logger = logging.getLogger("statesync.reactor")

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
_MAX_ADVERTISED = 10  # reference recentSnapshots


class StateSyncReactor(Reactor):
    def __init__(self, app_snapshot_conn, state_provider=None,
                 discovery_time: float = 2.0, **syncer_opts):
        super().__init__("statesync")
        self.app = app_snapshot_conn
        self.syncer: Syncer | None = None
        if state_provider is not None:
            self.syncer = Syncer(app_snapshot_conn, state_provider,
                                 self._request_chunk, discovery_time,
                                 request_snapshots=self._request_snapshots,
                                 on_strike=self._strike_peer,
                                 **syncer_opts)

    def _strike_peer(self, peer_id: str, reason: str) -> None:
        """Route a syncer-detected fault (quarantined poisoner,
        advertisement flood) into the behaviour trust score. Soft
        strike: the quarantine already bans the peer from the pool;
        the trust metric accumulates toward a switch-level stop."""
        sw = self.switch
        reporter = getattr(sw, "reporter", None) if sw is not None \
            else None
        if reporter is None:
            return
        try:
            reporter.observe(peer_id, bad=1)
            logger.warning("statesync strike on %s: %s",
                           peer_id[:8], reason)
        except Exception:  # conduct accounting must not fail the sync
            logger.exception("statesync behaviour strike failed")

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10,
                              recv_message_capacity=MAX_MSG_SIZE,
                              name="snapshot"),
            ChannelDescriptor(id=CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=16,
                              recv_message_capacity=MAX_MSG_SIZE,
                              name="chunk"),
        ]

    # -- client side --

    async def sync(self):
        """Discover + restore; returns (state, commit)
        (reference reactor.go:480 Sync via syncer.SyncAny)."""
        assert self.syncer is not None, "no state provider wired"
        sw = self.switch
        if sw is not None:
            sw.broadcast(SNAPSHOT_CHANNEL,
                         encode_ss_msg(SnapshotsRequestMessage()))
        consensus_metrics().state_syncing.set(1)
        statesync_metrics().syncing.set(1)
        try:
            return await self.syncer.sync_any()
        finally:
            consensus_metrics().state_syncing.set(0)
            statesync_metrics().syncing.set(0)

    def _request_snapshots(self) -> None:
        sw = self.switch
        if sw is not None:
            sw.broadcast(SNAPSHOT_CHANNEL,
                         encode_ss_msg(SnapshotsRequestMessage()))

    async def _request_chunk(self, peer_id: str, snapshot, index: int
                             ) -> None:
        sw = self.switch
        peer = sw.peers.get(peer_id) if sw is not None else None
        if peer is None:
            if self.syncer is not None:
                self.syncer.remove_peer(peer_id)
            return
        await peer.send(CHUNK_CHANNEL, encode_ss_msg(ChunkRequestMessage(
            height=snapshot.height, format=snapshot.format, index=index)))

    # -- p2p --

    async def add_peer(self, peer) -> None:
        if self.syncer is not None:
            peer.try_send(SNAPSHOT_CHANNEL,
                          encode_ss_msg(SnapshotsRequestMessage()))

    async def remove_peer(self, peer, reason) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    async def receive(self, chan_id: int, peer, msgb: bytes) -> None:
        msg = decode_ss_msg(msgb)
        if chan_id == SNAPSHOT_CHANNEL:
            if isinstance(msg, SnapshotsRequestMessage):
                for s in await self._recent_snapshots():
                    await peer.send(SNAPSHOT_CHANNEL, encode_ss_msg(
                        SnapshotsResponseMessage(
                            height=s.height, format=s.format,
                            chunks=s.chunks, hash=s.hash,
                            metadata=s.metadata)))
            elif isinstance(msg, SnapshotsResponseMessage):
                count("snapshots_discovered")
                if self.syncer is not None:
                    self.syncer.add_snapshot(peer.id, Snapshot(
                        height=msg.height, format=msg.format,
                        chunks=msg.chunks, hash=msg.hash,
                        metadata=msg.metadata))
            else:
                raise ValueError("bad msg on snapshot channel")
        elif chan_id == CHUNK_CHANNEL:
            if isinstance(msg, ChunkRequestMessage):
                res = await self.app.load_snapshot_chunk(
                    abci.RequestLoadSnapshotChunk(
                        height=msg.height, format=msg.format,
                        chunk=msg.index))
                count("chunks_served")
                # chaos: `corrupt` here turns THIS node into a chunk
                # poisoner (the e2e statesync_poison attack shape) —
                # syncing peers must quarantine it by name and finish
                # the restore from honest holders
                chunk = res.chunk
                if chunk:
                    chunk = failpoints.hit("statesync.serve",
                                           payload=chunk)
                await peer.send(CHUNK_CHANNEL, encode_ss_msg(
                    ChunkResponseMessage(
                        height=msg.height, format=msg.format,
                        index=msg.index, chunk=chunk,
                        missing=not res.chunk)))
            elif isinstance(msg, ChunkResponseMessage):
                count("chunks_received")
                if self.syncer is not None:
                    self.syncer.add_chunk(msg, peer.id)
            else:
                raise ValueError("bad msg on chunk channel")

    async def _recent_snapshots(self) -> list[Snapshot]:
        res = await self.app.list_snapshots()
        out = []
        for s in sorted(res.snapshots, key=lambda s: (-s.height, s.format)):
            out.append(Snapshot(height=s.height, format=s.format,
                                chunks=s.chunks, hash=s.hash,
                                metadata=s.metadata))
            if len(out) >= _MAX_ADVERTISED:
                break
        return out
