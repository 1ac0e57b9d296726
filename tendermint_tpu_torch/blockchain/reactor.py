"""Fast-sync reactor (reference: blockchain/reactor.py; Go
blockchain/v0/reactor.go, channel 0x40): serves committed blocks to catching-up peers and, when started
in fast-sync mode, drives the BlockPool to download, verify and apply
blocks until caught up, then hands off to consensus
(SwitchToConsensus, reference v0/reactor.go poolRoutine).

The hot loop: the Go reference verifies one commit per block
(`VerifyCommitLight`, sequential per-sig). Here a contiguous window of
fetched blocks is verified as ONE signature batch (verify_ahead.py):
up to BATCH_WINDOW commits in one structured K3 launch over the set's
comb tables (K2's sign-byte assembly inside it), and the next window's
batch verifies while this window's blocks are applied. apply_block
then validates each block as the reference does (state/validation.py:
its LastCommit re-verified, one structured K3 launch a block at 128
validators or more).

Progress records into the reference's blockchain family and the
consensus family's fast_syncing gauge (libs/metrics.py).

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError in the pool routine (a
window's K3 launch, apply_block's) halts the node through the Switch
(``Reactor.halt``) and ``wait_synced`` re-raises it. The reference's
routine logs "fast-sync pool routine died" and the sync stalls
silently."""

from __future__ import annotations

import asyncio
import logging
import time

from ..crypto.batch import UNCAUGHT
from ..libs.metrics import blockchain_metrics, consensus_metrics
from ..p2p.conn.connection import ChannelDescriptor
from ..p2p.switch import Reactor
from .msgs import (
    BlockRequestMessage,
    BlockResponseMessage,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
    decode_bc_msg,
    encode_bc_msg,
)
from .pool import BlockPool
from .verify_ahead import BATCH_WINDOW, WindowPipeline

logger = logging.getLogger("blockchain")

BLOCKCHAIN_CHANNEL = 0x40

TRY_SYNC_INTERVAL = 0.01          # reference trySyncTicker (10ms)
STATUS_UPDATE_INTERVAL = 10.0     # reference statusUpdateTicker
SWITCH_TO_CONSENSUS_INTERVAL = 1.0
SYNC_TIMEOUT = 60.0               # reference syncTimeout: no progress →
                                  # give up waiting and run consensus

class BlockchainReactor(Reactor):
    def __init__(self, state, block_exec, block_store,
                 fast_sync: bool, consensus_reactor=None,
                 verify_ahead: bool = True):
        super().__init__("blockchain")
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.fast_sync = fast_sync
        self.consensus_reactor = consensus_reactor
        self.pool = BlockPool(block_store.height + 1
                              if block_store.height else
                              state.last_block_height + 1)
        self._task: asyncio.Task | None = None
        self.synced = asyncio.Event()
        if not fast_sync:
            self.synced.set()
        self.fault: BaseException | None = None  # what halted the node
        self.blocks_synced = 0
        # Overlapped execution (verify_ahead.py WindowPipeline): while
        # window W's blocks execute through apply_block, window W+1's
        # commits — already buffered, their verdicts fully determined
        # by the fetched blocks — verify concurrently in an executor
        # thread. Pure pipelining: verdicts are identical either way,
        # and the save_block -> apply_block persistence order is
        # untouched (tools/crash_sweep.py is the acceptance gate).
        self.pipeline = WindowPipeline(enabled=verify_ahead)

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=BLOCKCHAIN_CHANNEL, priority=10,
                                  send_queue_capacity=1000,
                                  recv_message_capacity=10_485_760 + 1024,
                                  name="blockchain")]

    async def start(self) -> None:
        if self.fast_sync and self._task is None:
            consensus_metrics().fast_syncing.set(1)
            self._task = asyncio.get_running_loop().create_task(
                self._pool_routine(), name="blockchain-pool")

    async def switch_to_fast_sync(self, state) -> None:
        """Statesync → fastsync handoff (reference node.go:132)."""
        self.state = state
        self.fast_sync = True
        self.synced.clear()
        self.pool = BlockPool(state.last_block_height + 1)
        self.pipeline.reset()
        if self._task is not None and self._task.done():
            self._task = None
        await self.start()

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def on_halt(self, exc: BaseException) -> None:
        """The node halts on a port fault: the sync ends with it."""
        if self.fault is None:
            self.fault = exc
        self.synced.set()

    async def wait_synced(self, timeout: float | None = None) -> None:
        """Return once fast sync has handed over; re-raise what halted
        the node."""
        await asyncio.wait_for(self.synced.wait(), timeout)
        if self.fault is not None:
            if self.switch is not None:
                await self.switch.wait_halted()  # the node has stopped
            raise self.fault

    # -- p2p --

    def _our_status(self) -> bytes:
        return encode_bc_msg(StatusResponseMessage(
            height=self.block_store.height, base=self.block_store.base))

    async def add_peer(self, peer) -> None:
        peer.try_send(BLOCKCHAIN_CHANNEL, self._our_status())

    async def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    async def receive(self, chan_id: int, peer, msgb: bytes) -> None:
        msg = decode_bc_msg(msgb)
        if isinstance(msg, BlockRequestMessage):
            block = self.block_store.load_block(msg.height)
            if block is not None:
                await peer.send(BLOCKCHAIN_CHANNEL, encode_bc_msg(
                    BlockResponseMessage(block)))
            else:
                await peer.send(BLOCKCHAIN_CHANNEL, encode_bc_msg(
                    NoBlockResponseMessage(msg.height)))
        elif isinstance(msg, StatusRequestMessage):
            peer.try_send(BLOCKCHAIN_CHANNEL, self._our_status())
        elif isinstance(msg, StatusResponseMessage):
            self.pool.set_peer_range(peer.id, msg.base, msg.height)
        elif isinstance(msg, NoBlockResponseMessage):
            self.pool.no_block(peer.id, msg.height)
        elif isinstance(msg, BlockResponseMessage):
            blockchain_metrics().block_bytes_received.inc(len(msgb))
            self.pool.add_block(peer.id, msg.block, len(msgb))
        else:
            raise ValueError(f"unknown blockchain msg {type(msg)}")

    # -- sync driver --

    async def _pool_routine(self) -> None:
        last_status = 0.0
        last_switch_check = 0.0
        try:
            while True:
                now = time.monotonic()
                bmet = blockchain_metrics()
                bmet.pool_height.set(self.pool.height)
                bmet.pending_requests.set(len(self.pool.requests))
                bmet.num_peers.set(len(self.pool.peers))
                # expire slow/dead peers
                for pid in self.pool.tick(now):
                    self.pool.remove_peer(pid)
                    sw = self.switch
                    if sw is not None and pid in sw.peers:
                        sw._on_peer_error(sw.peers[pid],
                                          RuntimeError("fast-sync timeout"))
                # issue new requests
                sw = self.switch
                if sw is not None:
                    for pid, height in self.pool.make_next_requests(now):
                        peer = sw.peers.get(pid)
                        if peer is None:
                            self.pool.remove_peer(pid)
                            continue
                        peer.try_send(BLOCKCHAIN_CHANNEL, encode_bc_msg(
                            BlockRequestMessage(height)))
                # periodic status poll
                if now - last_status > STATUS_UPDATE_INTERVAL or \
                        not self.pool.peers:
                    last_status = now
                    if sw is not None:
                        sw.broadcast(BLOCKCHAIN_CHANNEL, encode_bc_msg(
                            StatusRequestMessage()))
                # drain what we can
                while await self._try_sync():
                    pass
                # caught up?
                if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                    last_switch_check = now
                    stalled = self.pool.last_advance is not None and \
                        now - self.pool.last_advance > SYNC_TIMEOUT
                    if self.pool.is_caught_up() or stalled:
                        if stalled and not self.pool.is_caught_up():
                            logger.warning(
                                "no fast-sync progress for %.0fs; "
                                "switching to consensus", SYNC_TIMEOUT)
                        logger.info("fast sync complete at height %d "
                                    "(%d blocks)", self.pool.height - 1,
                                    self.blocks_synced)
                        self.synced.set()
                        consensus_metrics().fast_syncing.set(0)
                        if self.consensus_reactor is not None:
                            await self.consensus_reactor.\
                                switch_to_consensus(self.state)
                        return
                await asyncio.sleep(TRY_SYNC_INTERVAL)
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("fast-sync pool routine died")

    async def _try_sync(self) -> bool:
        """Verify+apply a window of contiguous fetched blocks. Block i
        is verified with block i+1's LastCommit, so with W+1 buffered
        blocks, W are verifiable — in one signature batch when the
        validator set is stable (the overwhelmingly common case).
        While this window's blocks execute, the NEXT window's batch
        verifies concurrently (verify-ahead), so steady-state catch-up
        pays max(verify, apply) per window instead of their sum."""
        blocks = self.pool.peek_blocks(BATCH_WINDOW + 1)
        if len(blocks) < 2:
            return False
        vals = self.state.validators
        chain_id = self.state.chain_id
        items, parts_list, results = await self.pipeline.verdicts(
            vals, chain_id, blocks)
        self.pipeline.start_ahead(vals, chain_id,
                                  self.pool.peek_blocks, len(blocks))

        applied = 0
        now = time.monotonic()
        assumed_vals_hash = vals.hash()
        for i, err in enumerate(results):
            if err is not None:
                # The failure implicates BOTH peers: the one that served
                # block H (possibly forged) and the one that served
                # block H+1 carrying the LastCommit used to verify H
                # (possibly forged commit). Redo + ban both, mirroring
                # reference blockchain/v0/reactor.go:409 — otherwise a
                # byzantine peer serving H+1 with a bad commit keeps its
                # block buffered while honest H-servers get banned one
                # by one, stalling the sync.
                bad_heights = (items[i][1], blocks[i + 1].header.height)
                sw = self.switch
                for h in bad_heights:
                    peer_id = self.pool.redo_request(h)
                    logger.warning(
                        "block %d failed verification (%s); banning "
                        "peer %s", h, err, peer_id,
                    )
                    if sw is not None and peer_id in sw.peers:
                        rep = getattr(sw, "reporter", None)
                        if rep is not None:
                            # feed the trust metric before the hard stop
                            rep.observe(peer_id, bad=1)
                        sw._on_peer_error(sw.peers[peer_id],
                                          RuntimeError(f"bad block: {err}"))
                break
            first = blocks[i]
            bid = items[i][0]
            # the part set built (off-loop) by the verify job — never
            # re-serialize a full block on the event loop
            parts = parts_list[i]
            self.pool.pop_request(now)
            self.block_store.save_block(first, parts, blocks[i + 1].last_commit)
            self.state, _ = await self.block_exec.apply_block(
                self.state, bid, first)
            self.blocks_synced += 1
            applied += 1
            blockchain_metrics().blocks_synced.inc()
            if self.state.validators.hash() != assumed_vals_hash:
                # validator set changed mid-window: the remaining
                # verdicts were computed against the wrong set — leave
                # those blocks buffered for re-verification next pass
                # (any in-flight verify-ahead window is stale too: its
                # key carries the old valset hash, so the next pass
                # discards it and re-verifies under the new set)
                break
        return applied > 0
