"""Evidence reactor: gossips pending evidence on channel 0x38
(reference: evidence/reactor.py; Go evidence/reactor.go:15,29).

Per-peer broadcast task walks the pool's CList with blocking waits
(same pattern as the mempool reactor); evidence is only sent once the
peer's consensus height is past the evidence height, so the receiver
can actually verify it (reference reactor.go checkSendEvidenceMessage).

The port's rule for its own faults (crypto/batch.py UNCAUGHT): a
KernelError or NoDeviceError from ``add_evidence`` (verify_evidence's
K4 launch) leaves receive as any non-evidence error does, and the
Switch halts the node for it instead of stopping the peer; the
broadcast routine halts the node where the reference logs and dies."""

from __future__ import annotations

import asyncio
import logging

from ..crypto.batch import UNCAUGHT
from ..encoding.proto import Reader, Writer
from ..p2p.conn.connection import ChannelDescriptor
from ..p2p.switch import Reactor
from ..types.evidence import evidence_from_bytes
from .verify import EvidenceError

logger = logging.getLogger("evidence.reactor")

EVIDENCE_CHANNEL = 0x38
_BROADCAST_SLEEP = 0.01
_PEER_CATCHUP_SLEEP = 0.1  # reference peerCatchupSleepIntervalMS


def encode_evidence_list(evs: list) -> bytes:
    w = Writer()
    for ev in evs:
        w.bytes(1, ev.to_bytes(), skip_empty=False)
    return w.finish()


def decode_evidence_list(data: bytes) -> list:
    r = Reader(data)
    out = []
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            out.append(evidence_from_bytes(r.bytes()))
        else:
            r.skip(wt)
    return out


class EvidenceReactor(Reactor):
    def __init__(self, pool):
        super().__init__("evidence")
        self.pool = pool
        self._peer_tasks: dict[str, asyncio.Task] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100,
                                  name="evidence")]

    async def add_peer(self, peer) -> None:
        self._peer_tasks[peer.id] = asyncio.get_running_loop().create_task(
            self._broadcast_routine(peer),
            name=f"evidence-broadcast-{peer.id[:8]}")

    async def remove_peer(self, peer, reason) -> None:
        t = self._peer_tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    async def stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()
        self._peer_tasks.clear()

    async def receive(self, chan_id: int, peer, msgb: bytes) -> None:
        evs = decode_evidence_list(msgb)
        if not evs:
            raise ValueError("empty evidence message")
        for ev in evs:
            try:
                self.pool.add_evidence(ev)
            except EvidenceError as e:
                # invalid evidence is a peer offense (reference switches
                # peer to error); stale-but-honest races just log
                raise ValueError(f"peer sent invalid evidence: {e}") from e

    def _peer_height(self, peer) -> int:
        """Peer's consensus height, via the consensus reactor's
        PeerState stashed on the peer kv (reference: evidence reactor
        reads types.PeerStateKey)."""
        ps = peer.get("consensus_peer_state")
        return ps.height if ps is not None else 0

    async def _broadcast_routine(self, peer) -> None:
        try:
            e = await self.pool.evidence_list.front_wait()
            while True:
                ev = e.value
                # wait until the peer can verify this evidence
                while True:
                    ph = self._peer_height(peer)
                    if ph > ev.height():
                        break
                    await asyncio.sleep(_PEER_CATCHUP_SLEEP)
                if self.pool.is_pending(ev):
                    ok = await peer.send(EVIDENCE_CHANNEL,
                                         encode_evidence_list([ev]))
                    if not ok:
                        await asyncio.sleep(_BROADCAST_SLEEP)
                        continue
                nxt = await e.next_wait()
                e = nxt if nxt is not None else \
                    await self.pool.evidence_list.front_wait()
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("evidence broadcast to %r died", peer)
