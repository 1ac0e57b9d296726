"""Block pool: tracks which peer owes us which height and buffers
fetched blocks until the reactor verifies+applies them in order
(reference: blockchain/v0/pool.go:69).

Redesign: the reference runs one goroutine per in-flight height; here
the pool is a PURE state machine — no tasks, no clocks of its own
(v2's testability lesson, blockchain/v2/scheduler.go). The reactor
calls `make_next_requests(now)` / `tick(now)` and performs the IO the
pool decides on. Determinism makes the catch-up path unit-testable
without sockets."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

logger = logging.getLogger("blockchain.pool")

MAX_PENDING_REQUESTS = 600       # reference pool.go maxPendingRequests
MAX_PENDING_PER_PEER = 20        # reference maxPendingRequestsPerPeer
REQUEST_TIMEOUT = 15.0           # reference requestRetrySeconds-ish
MIN_RECV_RATE = 7680             # bytes/s, reference minRecvRate


@dataclass
class _Peer:
    id: str
    base: int = 0
    height: int = 0
    pending: set[int] = field(default_factory=set)
    bytes_received: int = 0
    first_request_at: float = 0.0


@dataclass
class _Request:
    height: int
    peer_id: str
    sent_at: float
    block: object | None = None


class BlockPool:
    """next height to fetch is `self.height`; blocks wait in
    `self.requests[h].block` until popped in order."""

    def __init__(self, start_height: int):
        self.height = start_height
        self.peers: dict[str, _Peer] = {}
        self.requests: dict[int, _Request] = {}
        self._banned: set[str] = set()
        # monotonic timestamp of the last height advance; fed by the
        # reactor's clock (None until the first tick) so the pool stays
        # clock-free and deterministic in tests
        self.last_advance: float | None = None

    # -- peers --

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        if peer_id in self._banned:
            return
        p = self.peers.get(peer_id)
        if p is None:
            p = _Peer(peer_id)
            self.peers[peer_id] = p
        if height < p.height:
            # peer shrank its chain: suspicious but tolerated (reference
            # allows lower StatusResponse after reorg-free guarantee)
            pass
        p.base, p.height = base, height

    def remove_peer(self, peer_id: str, ban: bool = False) -> list[int]:
        """Drop the peer; returns heights that must be re-requested."""
        p = self.peers.pop(peer_id, None)
        if ban:
            self._banned.add(peer_id)
        redo = []
        if p is not None:
            for h in p.pending:
                req = self.requests.get(h)
                if req is not None and req.peer_id == peer_id and \
                        req.block is None:
                    del self.requests[h]
                    redo.append(h)
        return redo

    def max_peer_height(self) -> int:
        return max((p.height for p in self.peers.values()), default=0)

    # -- request scheduling (pure; the reactor does the sends) --

    def make_next_requests(self, now: float) -> list[tuple[str, int]]:
        """Assign unrequested heights to available peers. Returns
        (peer_id, height) pairs for the reactor to send."""
        out: list[tuple[str, int]] = []
        h = self.height
        while len(self.requests) < MAX_PENDING_REQUESTS:
            while h in self.requests:
                h += 1
            peer = self._pick_peer(h)
            if peer is None:
                break
            self.requests[h] = _Request(h, peer.id, now)
            peer.pending.add(h)
            if not peer.first_request_at:
                peer.first_request_at = now
            out.append((peer.id, h))
            h += 1
        return out

    def _pick_peer(self, height: int) -> _Peer | None:
        best = None
        for p in self.peers.values():
            if len(p.pending) >= MAX_PENDING_PER_PEER:
                continue
            if not (p.base <= height <= p.height):
                continue
            if best is None or len(p.pending) < len(best.pending):
                best = p
        return best

    def tick(self, now: float) -> list[str]:
        """Expire timed-out requests; returns peer ids to drop
        (reference: requestRoutine timeout → RemovePeer)."""
        if self.last_advance is None:
            self.last_advance = now
        bad: set[str] = set()
        for req in list(self.requests.values()):
            if req.block is None and now - req.sent_at > REQUEST_TIMEOUT:
                bad.add(req.peer_id)
        # slow-peer detection (reference pool.go:139 minRecvRate)
        for p in self.peers.values():
            if p.pending and p.first_request_at and \
                    now - p.first_request_at > REQUEST_TIMEOUT:
                rate = p.bytes_received / (now - p.first_request_at)
                if rate < MIN_RECV_RATE and p.bytes_received > 0:
                    bad.add(p.id)
        return list(bad)

    # -- block ingestion --

    def add_block(self, peer_id: str, block, size: int) -> bool:
        """Accept a block only from the peer we asked (DoS guard,
        reference pool.go AddBlock)."""
        h = block.header.height
        req = self.requests.get(h)
        if req is None or req.peer_id != peer_id or req.block is not None:
            return False
        req.block = block
        p = self.peers.get(peer_id)
        if p is not None:
            p.pending.discard(h)
            p.bytes_received += size
        return True

    def no_block(self, peer_id: str, height: int) -> None:
        """Peer says it doesn't have the height: re-request elsewhere."""
        req = self.requests.get(height)
        if req is not None and req.peer_id == peer_id and req.block is None:
            del self.requests[height]
            p = self.peers.get(peer_id)
            if p is not None:
                p.pending.discard(height)
                # it lied about its range; shrink it
                if p.height >= height:
                    p.height = height - 1

    # -- ordered consumption --

    def peek_blocks(self, n: int = 2) -> list:
        """Up to n contiguous buffered blocks starting at self.height
        (reference PeekTwoBlocks generalized for cross-block batch
        verification)."""
        out = []
        for h in range(self.height, self.height + n):
            req = self.requests.get(h)
            if req is None or req.block is None:
                break
            out.append(req.block)
        return out

    def pop_request(self, now: float | None = None) -> None:
        req = self.requests.pop(self.height, None)
        assert req is not None and req.block is not None
        self.height += 1
        if now is not None:
            self.last_advance = now

    def redo_request(self, height: int) -> str:
        """Block at `height` failed verification: ban the peer that sent
        it (and anything else pending from it gets re-assigned)."""
        req = self.requests.get(height)
        if req is None:
            return ""
        peer_id = req.peer_id
        # drop every buffered block from the lying peer
        for h, r in list(self.requests.items()):
            if r.peer_id == peer_id:
                del self.requests[h]
        self.remove_peer(peer_id, ban=True)
        return peer_id

    def is_caught_up(self) -> bool:
        """reference pool.go IsCaughtUp: within 1 of the tallest peer
        (syncing H needs H+1 for the LastCommit, hence the -1)."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height() - 1
