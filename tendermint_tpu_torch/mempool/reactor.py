"""Mempool reactor: gossip valid txs on channel 0x30
(reference: mempool/reactor.py; Go mempool/reactor.go:33).

One broadcast task per peer walks the mempool CList with blocking
waits and streams txs; a tx is skipped for peers that already sent it
to us (senders dedup) and held back until the peer's consensus height
is close enough to validate it (reference broadcastTxRoutine).

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError from ``check_tx`` (an
admission flush's K4 launch) is not swallowed as gossip noise: receive
re-raises it and the Switch halts the node. The reference's receive
logs every check_tx exception and moves on. The broadcast routine
halts the node the same way."""

from __future__ import annotations

import asyncio
import logging

from ..crypto.batch import UNCAUGHT
from ..encoding.proto import Reader, Writer
from ..p2p.conn.connection import METRICS, ChannelDescriptor
from ..p2p.switch import Reactor

logger = logging.getLogger("mempool.reactor")

MEMPOOL_CHANNEL = 0x30
_PEER_CATCHUP_SLEEP = 0.1  # reference peerCatchupSleepIntervalMS
_MAX_TX_BATCH = 50


def encode_txs(txs: list[bytes]) -> bytes:
    w = Writer()
    for tx in txs:
        w.bytes(1, tx, skip_empty=False)
    return w.finish()


def decode_txs(data: bytes) -> list[bytes]:
    r = Reader(data)
    out = []
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            out.append(r.bytes())
        else:
            r.skip(wt)
    return out


class MempoolReactor(Reactor):
    def __init__(self, mempool, broadcast: bool = True):
        super().__init__("mempool")
        self.mempool = mempool
        self.broadcast = broadcast
        self._peer_tasks: dict[str, asyncio.Task] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(
            id=MEMPOOL_CHANNEL, priority=5, send_queue_capacity=100,
            recv_message_capacity=self.mempool.config.max_tx_bytes * 4 + 64,
            name="mempool")]

    async def add_peer(self, peer) -> None:
        if self.broadcast:
            self._peer_tasks[peer.id] = \
                asyncio.get_running_loop().create_task(
                    self._broadcast_routine(peer),
                    name=f"mempool-broadcast-{peer.id[:8]}")

    async def remove_peer(self, peer, reason) -> None:
        t = self._peer_tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    async def stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()
        self._peer_tasks.clear()

    async def receive(self, chan_id: int, peer, msgb: bytes) -> None:
        txs = decode_txs(msgb)
        if not txs:
            raise ValueError("empty mempool message")
        METRICS["num_txs"] += len(txs)
        for tx in txs:
            try:
                await self.mempool.check_tx(tx, {"sender": peer.id})
            except UNCAUGHT:
                raise
            except Exception as e:
                # Duplicates and full-pool are normal gossip noise, not
                # peer misbehavior (reference Receive logs and moves on).
                logger.debug("tx from %r rejected: %s", peer, e)

    def _peer_height(self, peer) -> int:
        ps = peer.get("consensus_peer_state")
        return ps.height if ps is not None else 0

    async def _broadcast_routine(self, peer) -> None:
        try:
            e = await self.mempool.txs.front_wait()
            while True:
                mtx = e.value
                # hold txs the peer can't process yet (reference checks
                # peer height >= mtx height - 1) — and hold ALL tx
                # gossip while the switch has the peer marked slow
                # (slow_level >= 1): tx bytes are the most shoveable
                # load, and piling them onto a saturated send queue
                # only evicts consensus traffic behind them
                while True:
                    ph = self._peer_height(peer)
                    if ph >= mtx.height - 1 and \
                            getattr(peer, "slow_level", 0) < 1:
                        break
                    await asyncio.sleep(_PEER_CATCHUP_SLEEP)
                if peer.id not in mtx.senders:
                    await peer.send(MEMPOOL_CHANNEL, encode_txs([mtx.tx]))
                nxt = await e.next_wait()
                e = nxt if nxt is not None else \
                    await self.mempool.txs.front_wait()
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("mempool broadcast to %r died", peer)
