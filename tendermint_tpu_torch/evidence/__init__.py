"""Evidence pool: pending/committed byzantine-behavior proof storage,
gossip feed, and proposal supply (reference: evidence/__init__.py; Go
evidence/pool.go:29). Verification is evidence/verify.py's: a
light-client attack added from a peer launches K4 as verify_evidence
does.

Pending evidence lives in the DB (prefix 0x00, keyed height‖hash so
iteration is proposal order) and on a CList the reactor's per-peer
broadcast routines walk. Committed hashes (prefix 0x01) block
re-admission forever; expiry prunes pending entries per the consensus
params' max-age (both height AND time must exceed, reference
pool.go:576 isExpired).

The reference's pool gauges and counters (evidence_metrics()) are the
port's ``METRICS`` dict; the evidence reactor waits for the port's p2p
stack."""

from __future__ import annotations

import logging

from ..libs.clist import CList
from ..types.evidence import Evidence, evidence_from_bytes
from .verify import EvidenceError, verify_evidence

logger = logging.getLogger("evidence")

# the last pool's size and pending bytes; process totals of the
# verified and committed pieces
METRICS: dict = {"pool_size": 0, "pool_bytes": 0, "verified": 0,
                 "committed": 0}

_PENDING = b"\x00"
_COMMITTED = b"\x01"


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + ev.height().to_bytes(8, "big") + ev.hash()


class Pool:
    def __init__(self, db, state_store, block_store):
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.state = state_store.load()
        self.evidence_list = CList()  # gossip feed
        self._pending_bytes = 0
        # refill the gossip list from persisted pending evidence
        for _, v in self.db.iterate_prefix(_PENDING):
            ev = evidence_from_bytes(v)
            self.evidence_list.push_back(ev)
            self._pending_bytes += len(v)
        self._set_pool_gauges()

    def _set_pool_gauges(self) -> None:
        METRICS["pool_size"] = len(self.evidence_list)
        METRICS["pool_bytes"] = self._pending_bytes

    # -- queries --

    def pending_evidence(self, max_bytes: int) -> list[Evidence]:
        """Ordered by height for proposal inclusion
        (reference: PendingEvidence)."""
        out, total = [], 0
        for _, v in self.db.iterate_prefix(_PENDING):
            if max_bytes >= 0 and total + len(v) > max_bytes:
                break
            out.append(evidence_from_bytes(v))
            total += len(v)
        return out

    def is_committed(self, ev: Evidence) -> bool:
        return self.db.get(_key(_COMMITTED, ev)) is not None

    def is_pending(self, ev: Evidence) -> bool:
        return self.db.get(_key(_PENDING, ev)) is not None

    # -- ingestion --

    def add_evidence(self, ev: Evidence) -> None:
        """From a peer or RPC: fully verified before admission
        (reference: pool.go:120 AddEvidence)."""
        if self.is_pending(ev) or self.is_committed(ev):
            return
        ev.validate_basic()
        verify_evidence(ev, self.state, self.state_store, self.block_store)
        METRICS["verified"] += 1
        self._persist_pending(ev)
        logger.info("added evidence %s h=%d", type(ev).__name__, ev.height())

    def add_evidence_from_consensus(self, ev: Evidence) -> None:
        """Consensus observed the equivocation itself — no re-verify
        (reference: pool.go AddEvidenceFromConsensus)."""
        if self.is_pending(ev) or self.is_committed(ev):
            return
        self._persist_pending(ev)
        logger.info("added own-observed evidence %s h=%d",
                    type(ev).__name__, ev.height())

    def _persist_pending(self, ev: Evidence) -> None:
        raw = ev.to_bytes()
        self.db.set(_key(_PENDING, ev), raw)
        self._pending_bytes += len(raw)
        self.evidence_list.push_back(ev)
        self._set_pool_gauges()

    # -- block validation hook --

    def check_evidence(self, evlist: list[Evidence]) -> None:
        """Every piece proposed in a block must be valid and fresh
        (reference: pool.go:181 CheckEvidence)."""
        seen = set()
        for ev in evlist:
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            if self.is_committed(ev):
                raise EvidenceError("evidence was already committed")
            if not self.is_pending(ev):
                ev.validate_basic()
                verify_evidence(ev, self.state, self.state_store,
                                self.block_store)

    # -- post-commit --

    def update(self, state, committed: list[Evidence]) -> None:
        """Mark committed, drop from pending, prune expired
        (reference: pool.go Update)."""
        self.state = state
        METRICS["committed"] += len(committed)
        for ev in committed:
            self.db.set(_key(_COMMITTED, ev), b"\x01")
            self._remove_pending(ev)
        self._prune_expired()
        self._set_pool_gauges()

    def _remove_pending(self, ev: Evidence) -> None:
        k = _key(_PENDING, ev)
        raw = self.db.get(k)
        if raw is not None:
            self.db.delete(k)
            self._pending_bytes -= len(raw)
        h = ev.hash()
        e = self.evidence_list.front()
        while e is not None:
            if e.value.hash() == h:
                self.evidence_list.remove(e)
                break
            e = e.next()

    def _prune_expired(self) -> None:
        p = self.state.consensus_params.evidence
        for k, v in list(self.db.iterate_prefix(_PENDING)):
            ev = evidence_from_bytes(v)
            age_blocks = self.state.last_block_height - ev.height()
            ev_time = getattr(ev, "timestamp", 0)
            age_ns = self.state.last_block_time - ev_time
            if age_blocks > p.max_age_num_blocks and \
                    age_ns > p.max_age_duration_ns:
                self._remove_pending(ev)
                logger.info("pruned expired evidence h=%d", ev.height())

    def size(self) -> int:
        return len(self.evidence_list)
