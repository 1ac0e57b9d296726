"""Snapshot pool: collect snapshot advertisements from peers and rank
them (reference: statesync/snapshots.py; Go statesync/snapshots.go:45
snapshotPool).

Ranking (reference :176 Best): higher height first, then lower format
... then most peers. Rejected snapshots/formats/peers are remembered
so SyncAny never retries them.

The pool is BOUNDED: a per-peer advertisement cap (an advertisement
flood from one peer is refused and surfaced via `on_peer_overflow` so
the reactor can strike its trust score) and a global cap under which
the DETERMINISTICALLY lowest-ranked snapshot is evicted first — an
advertisement flood costs the flooder its trust, never this node's
memory."""

from __future__ import annotations

from dataclasses import dataclass

# Bounds (no reference equivalent — snapshots.go grows without bound):
# a peer legitimately advertises at most recentSnapshots (10) entries
# per request, and the pool only needs enough depth to survive a few
# stale/rejected heads.
MAX_SNAPSHOTS_PER_PEER = 16
MAX_SNAPSHOTS = 64


@dataclass(frozen=True)
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""

    def key(self) -> tuple:
        return (self.height, self.format, self.chunks, self.hash)


class SnapshotPool:
    def __init__(self, per_peer_cap: int = MAX_SNAPSHOTS_PER_PEER,
                 global_cap: int = MAX_SNAPSHOTS,
                 on_peer_overflow=None):
        self.per_peer_cap = per_peer_cap
        self.global_cap = global_cap
        # sync callable (peer_id): the peer exceeded its advertisement
        # cap — the reactor routes this to a behaviour strike
        self.on_peer_overflow = on_peer_overflow
        self._snapshots: dict[tuple, Snapshot] = {}
        self._peers: dict[tuple, set[str]] = {}
        self._rejected_snapshots: set[tuple] = set()
        self._rejected_formats: set[int] = set()
        self._rejected_peers: set[str] = set()

    def _rank_key(self, s: Snapshot) -> tuple:
        # smaller sorts better; snapshot key is the deterministic
        # tiebreaker so eviction order never depends on dict order
        return (-s.height, s.format,
                -len(self._peers.get(s.key(), ())), s.key())

    def add(self, peer_id: str, snapshot: Snapshot) -> bool:
        """Returns True if this snapshot is new to the pool."""
        k = snapshot.key()
        if k in self._rejected_snapshots or \
                snapshot.format in self._rejected_formats or \
                peer_id in self._rejected_peers:
            return False
        if peer_id not in self._peers.get(k, ()):
            held = sum(1 for peers in self._peers.values()
                       if peer_id in peers)
            if held >= self.per_peer_cap:
                if self.on_peer_overflow is not None:
                    self.on_peer_overflow(peer_id)
                return False
        new = k not in self._snapshots
        if new and len(self._snapshots) >= self.global_cap:
            # evict the deterministically lowest-ranked entry; if the
            # newcomer would itself rank last, refuse it instead
            worst_k = max(self._snapshots,
                          key=lambda kk: self._rank_key(self._snapshots[kk]))
            new_rank = (-snapshot.height, snapshot.format, -1, k)
            if new_rank >= self._rank_key(self._snapshots[worst_k]):
                return False
            del self._snapshots[worst_k]
            self._peers.pop(worst_k, None)
        self._snapshots[k] = snapshot
        self._peers.setdefault(k, set()).add(peer_id)
        return new

    def best(self) -> Snapshot | None:
        ranked = sorted(self._snapshots.values(), key=self._rank_key)
        return ranked[0] if ranked else None

    def peers_of(self, snapshot: Snapshot) -> list[str]:
        return sorted(self._peers.get(snapshot.key(), set()))

    def reject(self, snapshot: Snapshot) -> None:
        self._rejected_snapshots.add(snapshot.key())
        self._snapshots.pop(snapshot.key(), None)

    def reject_format(self, format_: int) -> None:
        self._rejected_formats.add(format_)
        for k in [k for k, s in self._snapshots.items()
                  if s.format == format_]:
            del self._snapshots[k]

    def reject_peer(self, peer_id: str) -> None:
        self._rejected_peers.add(peer_id)
        self.remove_peer(peer_id)

    def is_rejected_peer(self, peer_id: str) -> bool:
        return peer_id in self._rejected_peers

    def rejected_peers(self) -> list[str]:
        return sorted(self._rejected_peers)

    def remove_peer(self, peer_id: str) -> None:
        for k, peers in list(self._peers.items()):
            peers.discard(peer_id)
            if not peers:
                del self._peers[k]
                self._snapshots.pop(k, None)

    def remove_peer_snapshot(self, peer_id: str, snapshot: Snapshot) -> None:
        """Dissociate ONE peer from ONE snapshot (it answered 'missing'
        for a chunk); other peers holding the snapshot keep serving it."""
        k = snapshot.key()
        peers = self._peers.get(k)
        if peers is None:
            return
        peers.discard(peer_id)
        if not peers:
            del self._peers[k]
            self._snapshots.pop(k, None)

    def __len__(self) -> int:
        return len(self._snapshots)
