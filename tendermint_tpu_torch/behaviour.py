"""Peer-behaviour reporting (reference: behaviour.py; Go
behaviour/reporter.go:12-40, peer_behaviour.go).

Reactors report peer conduct through one narrow interface instead of
poking the Switch directly; the SwitchReporter routes good reports into
the peer's EWMA trust metric (p2p/trust.py) and bad reports into both
the metric and — for hard faults or a collapsed trust score — the
Switch's stop-for-error path. The reference keeps trust and behaviour
separate (the metric is never wired in); here the reporter is the
integration point, which is what ADR-006 intended the metric for."""

from __future__ import annotations

from dataclasses import dataclass


# Behaviour kinds (reference behaviour/peer_behaviour.go):
#   good: consensus_vote, block_part
#   bad: bad_message, message_out_of_order
GOOD_KINDS = frozenset({"consensus_vote", "block_part"})
BAD_KINDS = frozenset({"bad_message", "message_out_of_order"})

# A peer whose trust score collapses below this after repeated soft
# faults gets disconnected even though no single fault was fatal.
STOP_SCORE = 20


@dataclass(frozen=True)
class PeerBehaviour:
    peer_id: str
    kind: str  # one of GOOD_KINDS | BAD_KINDS
    explanation: str = ""

    @classmethod
    def consensus_vote(cls, peer_id: str) -> "PeerBehaviour":
        return cls(peer_id, "consensus_vote")

    @classmethod
    def block_part(cls, peer_id: str) -> "PeerBehaviour":
        return cls(peer_id, "block_part")

    @classmethod
    def bad_message(cls, peer_id: str, explanation: str) -> "PeerBehaviour":
        return cls(peer_id, "bad_message", explanation)

    @classmethod
    def message_out_of_order(cls, peer_id: str,
                             explanation: str) -> "PeerBehaviour":
        return cls(peer_id, "message_out_of_order", explanation)


class Reporter:
    async def report(self, behaviour: PeerBehaviour) -> None:
        raise NotImplementedError


class SwitchReporter(Reporter):
    """Routes reports to the Switch + trust store
    (reference: behaviour/reporter.go SwitchReporter)."""

    def __init__(self, switch, trust_store=None,
                 stop_score: int = STOP_SCORE):
        from .p2p.trust import TrustMetricStore

        self.switch = switch
        self.trust = trust_store or TrustMetricStore()
        self.stop_score = stop_score

    def _peer(self, peer_id: str):
        return self.switch.peers.get(peer_id)

    def observe(self, peer_id: str, good: int = 0, bad: int = 0) -> None:
        """Synchronous bulk metric update — the consensus vote batch
        path calls this once per peer per batch with verified/rejected
        lane counts (crediting only VERIFIED contributions; crediting
        on receive would let a byzantine peer stream well-formed
        garbage and keep a perfect score)."""
        m = self.trust.get_metric(peer_id)
        if good:
            m.good_events(good)
        if bad:
            m.bad_events(bad)
        self.trust.maybe_tick()

    async def enforce(self, peer_id: str, reason: str) -> None:
        """Disconnect the peer if its trust score has collapsed
        (called after observe() recorded bad conduct)."""
        peer = self._peer(peer_id)
        if peer is None:
            return
        score = self.trust.get_metric(peer_id).trust_score()
        if score < self.stop_score:
            await self.switch.stop_peer_for_error(
                peer, f"trust score {score} < {self.stop_score}: {reason}")

    async def report(self, behaviour: PeerBehaviour) -> None:
        if behaviour.kind in GOOD_KINDS:
            self.observe(behaviour.peer_id, good=1)
            return
        if behaviour.kind not in BAD_KINDS:
            raise ValueError(f"unknown behaviour kind {behaviour.kind!r}")
        self.observe(behaviour.peer_id, bad=1)
        peer = self._peer(behaviour.peer_id)
        if peer is None:
            return
        if behaviour.kind == "message_out_of_order":
            # Protocol-order violations are hard faults (reference
            # stops the peer immediately for these).
            await self.switch.stop_peer_for_error(
                peer, behaviour.explanation)
        else:
            # Soft faults accumulate; disconnect on collapsed trust.
            await self.enforce(behaviour.peer_id, behaviour.explanation)

    def disconnected(self, peer_id: str) -> None:
        self.trust.peer_disconnected(peer_id)


class MockReporter(Reporter):
    """Records reports for reactor tests
    (reference: behaviour/reporter.go MockReporter)."""

    def __init__(self):
        self.reports: dict[str, list[PeerBehaviour]] = {}

    async def report(self, behaviour: PeerBehaviour) -> None:
        self.reports.setdefault(behaviour.peer_id, []).append(behaviour)
