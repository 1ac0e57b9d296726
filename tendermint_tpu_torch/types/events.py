"""Typed events + EventBus (reference: types/events.py; Go
types/events.go, event_bus.go).

The EventBus wraps libs.pubsub with the canonical event attribute
keys (tm.event, tx.height, tx.hash, ...) consumed by RPC subscribe
and the tx indexer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs.pubsub import PubSub, Query

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_UNLOCK = "Unlock"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_EVIDENCE = "NewEvidence"

TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event: str) -> Query:
    return Query.parse(f"{TYPE_KEY} = '{event}'")


QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
QUERY_TX = query_for_event(EVENT_TX)


@dataclass
class EventDataNewBlock:
    block: object
    result_begin_block: dict = field(default_factory=dict)
    result_end_block: dict = field(default_factory=dict)


@dataclass
class EventDataNewBlockHeader:
    header: object
    num_txs: int = 0


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    index: int
    result: dict = field(default_factory=dict)


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataVote:
    vote: object


@dataclass
class EventDataNewEvidence:
    evidence: object
    height: int


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list


class EventBus:
    """Typed publish API over a PubSub (reference: types/event_bus.go)."""

    def __init__(self):
        self.pubsub = PubSub()

    def subscribe(self, subscriber: str, query: Query,
                  buffer: int | None = None):
        return self.pubsub.subscribe(subscriber, query, buffer)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    def _publish(self, event_type: str, data, extra: dict[str, list[str]] | None = None):
        attrs = {TYPE_KEY: [event_type]}
        if extra:
            for k, v in extra.items():
                attrs.setdefault(k, []).extend(v)
        self.pubsub.publish(data, attrs)

    def publish_new_block(self, data: EventDataNewBlock, events: list | None = None):
        self._publish(EVENT_NEW_BLOCK, data, _abci_attrs(events))

    def publish_new_block_header(self, data: EventDataNewBlockHeader):
        self._publish(EVENT_NEW_BLOCK_HEADER, data)

    def publish_tx(self, data: EventDataTx, events: list | None = None):
        from .tx import tx_hash

        attrs = _abci_attrs(events) or {}
        attrs[TX_HASH_KEY] = [tx_hash(data.tx).hex().upper()]
        attrs[TX_HEIGHT_KEY] = [str(data.height)]
        self._publish(EVENT_TX, data, attrs)

    def publish_vote(self, data: EventDataVote):
        self._publish(EVENT_VOTE, data)

    def publish_new_round_step(self, data: EventDataRoundState):
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_new_round(self, data: EventDataRoundState):
        self._publish(EVENT_NEW_ROUND, data)

    def publish_complete_proposal(self, data: EventDataRoundState):
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_polka(self, data: EventDataRoundState):
        self._publish(EVENT_POLKA, data)

    def publish_lock(self, data: EventDataRoundState):
        self._publish(EVENT_LOCK, data)

    def publish_relock(self, data: EventDataRoundState):
        self._publish(EVENT_RELOCK, data)

    def publish_unlock(self, data: EventDataRoundState):
        self._publish(EVENT_UNLOCK, data)

    def publish_valid_block(self, data: EventDataRoundState):
        self._publish(EVENT_VALID_BLOCK, data)

    def publish_timeout_propose(self, data: EventDataRoundState):
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState):
        self._publish(EVENT_TIMEOUT_WAIT, data)

    def publish_new_evidence(self, data: EventDataNewEvidence):
        self._publish(EVENT_NEW_EVIDENCE, data)

    def publish_validator_set_updates(self, data: EventDataValidatorSetUpdates):
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)


def _abci_attrs(events: list | None) -> dict[str, list[str]] | None:
    """Flatten ABCI events ([{type, attributes:[{key,value}]}]) into
    'type.key' -> [values] attributes for query matching."""
    if not events:
        return None
    out: dict[str, list[str]] = {}
    for ev in events:
        etype = ev.get("type", "")
        for attr in ev.get("attributes", []):
            k = attr.get("key", "")
            if isinstance(k, bytes):
                k = k.decode()
            v = attr.get("value", "")
            if isinstance(v, bytes):
                v = v.decode()
            if etype and k:
                out.setdefault(f"{etype}.{k}", []).append(v)
    return out
