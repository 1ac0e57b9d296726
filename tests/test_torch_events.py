"""Port parity for the event bus and the indexers: libs/pubsub.py
(Query, Condition, PubSub, Subscription, QueryError), types/events.py
(EventBus, the EVENT_* names, _abci_attrs, query_for_event) and
state/txindex.py (TxResult, TxIndexer, BlockIndexer, IndexerService),
against the JAX package.

A table of queries is parsed by both packages (equal conditions, equal
errors) and matched against a table of attribute sets; the same seeded
tx results and block events are indexed by both (equal index keys and
bytes) and searched with the table (equal results). Tolerance: exact."""

import asyncio

import numpy as np
import pytest

from test_torch_execution import PACKAGES, PORT, REF, db_bytes, outcome

QUERIES = [
    "tm.event = 'Tx'",
    "tm.event='NewBlock'",
    "tx.height > 5",
    "tx.height >= 3 AND tx.height <= 4",
    "tx.height = 3",
    "tx.height = 3.5",
    "tx.height = 'abc'",
    "tx.hash CONTAINS 'AB'",
    "app.key = 'k7'",
    "app.key EXISTS",
    "app.creator = 'kvstore' AND app.key = 'k2'",
    "transfer.amount = 100",
    "transfer.amount > 99.5",
    "transfer.amount < 50",
    "transfer.recipient = 'cosmos1/x'",
    "transfer.recipient CONTAINS 'cosmos'",
    "block.height = 4",
    "block.height > 2 AND begin.kind = 'b'",
    "end.val EXISTS",
    "missing.key EXISTS",
    "a.b = -7",
]
BAD_QUERIES = ["", "tx.height", "tx.height >", "= 5", "tx.hash CONTAINS 5",
               "tx.height > abc", "tx.height ! 3", "AND AND"]
ATTRS = [
    {"tm.event": ["Tx"], "tx.height": ["3"], "tx.hash": ["ABCD"]},
    {"tm.event": ["NewBlock"]},
    {"tx.height": ["6", "x"], "app.key": ["k7", "k8"]},
    {"transfer.amount": ["100"], "transfer.recipient": ["cosmos1/x/y"]},
    {"transfer.amount": ["100.0", "20"], "a.b": ["-7"]},
    {},
]


def parsed(p, q):
    got = outcome(lambda: p.pubsub.Query.parse(q))
    if got[0] != "ok":
        return got
    query = got[1]
    return ([(c.key, c.op, c.value) for c in query.conditions], str(query),
            [query.matches(a) for a in ATTRS])


@pytest.mark.parametrize("q", QUERIES + BAD_QUERIES)
def test_query_parse_and_match_equal_reference(q):
    assert parsed(PORT, q) == parsed(REF, q)


def test_pubsub_subscriptions_equal_reference():
    """Subscribe / unsubscribe errors, drop-oldest on a full buffer, and
    which subscriber sees which message."""
    async def go(p):
        ps = p.pubsub.PubSub(buffer=3)
        qa = p.pubsub.Query.parse("tm.event = 'Tx'")
        qb = p.pubsub.Query.parse("tx.height > 2")
        sa, sb = ps.subscribe("a", qa), ps.subscribe("b", qb)
        errs = [outcome(lambda: ps.subscribe("a", qa)),
                outcome(lambda: ps.unsubscribe("c", qa))]
        for i in range(6):
            ps.publish(i, {"tm.event": ["Tx"], "tx.height": [str(i)]})
        ps.publish("x", {"other": ["1"]})
        got_a = [(await sa.next()).data for _ in range(3)]
        got_b = [(await sb.next()).data for _ in range(3)]
        n = ps.num_subscribers
        ps.unsubscribe("a", qa)
        cancelled = await asyncio.gather(sa.next(), return_exceptions=True)
        ps.unsubscribe_all("b")
        return (errs, got_a, got_b, n, ps.num_subscribers,
                type(cancelled[0]).__name__, p.pubsub.ALL.matches({}))

    got = [asyncio.run(go(p)) for p in (PORT, REF)]
    assert got[0] == got[1]
    assert got[0][1] == [3, 4, 5] and got[0][5] == "CancelledError"


def test_event_bus_attributes_equal_reference():
    """publish_* stamps tm.event and, for a tx, tx.hash and tx.height
    over the flattened ABCI events; every EVENT_* name is the
    reference's."""
    names = sorted(n for n in vars(REF.events) if n.startswith("EVENT_"))
    assert [getattr(PORT.events, n) for n in names] == \
        [getattr(REF.events, n) for n in names]

    async def go(p):
        bus = p.events.EventBus()
        sub = bus.subscribe("s", p.pubsub.Query.parse("tm.event EXISTS"))
        evs = [{"type": "app", "attributes": [
            {"key": b"key", "value": b"v1"}, {"key": "creator",
                                              "value": "kv"}]},
            {"type": "", "attributes": [{"key": "dropped", "value": "1"}]}]
        bus.publish_tx(p.events.EventDataTx(7, b"tx-bytes", 2), evs)
        bus.publish_new_block(p.events.EventDataNewBlock(None), evs)
        bus.publish_vote(p.events.EventDataVote(None))
        bus.publish_new_round_step(p.events.EventDataRoundState(1, 0, "x"))
        bus.publish_new_evidence(p.events.EventDataNewEvidence(None, 3))
        bus.publish_validator_set_updates(
            p.events.EventDataValidatorSetUpdates([]))
        out = []
        while not sub.queue.empty():
            m = sub.queue.get_nowait()
            out.append((type(m.data).__name__, m.attrs))
        return (out, p.events._abci_attrs(evs), p.events._abci_attrs(None),
                str(p.events.QUERY_TX), str(p.events.query_for_event("Vote")))

    got = [asyncio.run(go(p)) for p in (PORT, REF)]
    assert got[0] == got[1] and len(got[0][0]) == 6


def tx_results(p, n: int = 40):
    rng = np.random.default_rng(15)
    out = []
    for i in range(n):
        h, idx = 1 + i // 5, i % 5
        events = [{"type": "app", "attributes": [
            {"key": "creator", "value": "kvstore"},
            {"key": "key", "value": "k%d" % int(rng.integers(0, 9))}]}]
        if i % 3 == 0:
            events.append({"type": "transfer", "attributes": [
                {"key": "amount", "value": str(int(rng.integers(0, 200)))},
                {"key": "recipient", "value": "cosmos1/x" + "/y" * (i % 2)}]})
        out.append(p.txindex.TxResult(h, idx, b"tx-%d" % i,
                                      {"code": 0, "log": "", "events": events}))
    return out


def block_events(h: int):
    return ({"events": [{"type": "begin", "attributes": [
                {"key": "kind", "value": "b" if h % 2 else "a"}]}]},
            {"events": [{"type": "end", "attributes": [
                {"key": "val", "value": str(h)}]}]} if h % 3 else {})


@pytest.mark.parametrize("q", QUERIES)
def test_indexer_search_equals_reference(q):
    got = []
    for p in (PORT, REF):
        txi = p.txindex.TxIndexer(p.db.MemDB())
        for tr in tx_results(p):
            txi.index(tr)
        blki = p.txindex.BlockIndexer(p.db.MemDB())
        for h in range(1, 9):
            blki.index(h, *block_events(h))
        query = p.pubsub.Query.parse(q)
        got.append(([(t.height, t.index, t.tx, t.result)
                     for t in txi.search(query)], blki.search(query),
                    db_bytes(txi.db), db_bytes(blki.db)))
    assert got[0] == got[1]


def test_indexer_get_and_hash_equal_reference():
    got = []
    for p in (PORT, REF):
        txi = p.txindex.TxIndexer(p.db.MemDB())
        trs = tx_results(p, 6)
        for tr in trs:
            txi.index(tr)
        got.append(([tr.hash() for tr in trs],
                     [vars(txi.get(tr.hash())) for tr in trs],
                     txi.get(b"\x00" * 32)))
    assert got[0] == got[1] and got[0][2] is None


def test_indexer_service_over_the_event_bus():
    """IndexerService indexes each published Tx and NewBlock; stop()
    unsubscribes and cancels its tasks."""
    async def go(p):
        bus = p.events.EventBus()
        svc = p.txindex.IndexerService(p.txindex.TxIndexer(p.db.MemDB()), bus,
                                       p.txindex.BlockIndexer(p.db.MemDB()))
        svc.start()
        for tr in tx_results(p, 10):
            bus.publish_tx(p.events.EventDataTx(tr.height, tr.tx, tr.index,
                                                tr.result),
                           tr.result["events"])
        for h in (1, 2):
            begin, end = block_events(h)
            bus.publish_new_block(p.events.EventDataNewBlock(
                type("B", (), {"header": type("H", (), {"height": h})})(),
                begin, end))
        for _ in range(200):
            await asyncio.sleep(0)
        n = bus.pubsub.num_subscribers
        svc.stop()
        await asyncio.sleep(0)
        return (db_bytes(svc.indexer.db), db_bytes(svc.block_indexer.db), n,
                bus.pubsub.num_subscribers)

    got = [asyncio.run(go(p)) for p in (PORT, REF)]
    assert got[0] == got[1] and got[0][2:] == (2, 0)


def test_indexer_service_keeps_every_tx_past_the_bus_buffer():
    """A recorded divergence (ROADMAP Queue C): 1,100 Tx events published
    before the service runs, past the bus's buffer of 1,024. The port's
    unbounded subscription indexes all of them, in one db batch; the JAX
    package's drop-oldest queue loses the oldest 76. What both index
    equals, and equals TxIndexer.index one result at a time."""
    n, buffer = 1100, 1024

    async def go(p):
        bus = p.events.EventBus()
        db = p.db.MemDB()
        batches = []
        write_batch = db.write_batch
        db.write_batch = lambda ops: (batches.append(len(ops)),
                                      write_batch(ops))
        svc = p.txindex.IndexerService(p.txindex.TxIndexer(db), bus)
        svc.start()
        for tr in tx_results(p, n):
            bus.publish_tx(p.events.EventDataTx(tr.height, tr.tx, tr.index,
                                                tr.result),
                           tr.result["events"])
        idle = 0
        while idle < 16:  # a message takes a few loop turns past its get
            await asyncio.sleep(0)
            idle = 0 if not svc._sub.queue.empty() else idle + 1
        svc.stop()
        return db_bytes(db), len(batches)

    (port_db, port_batches), (ref_db, ref_batches) = [
        asyncio.run(go(p)) for p in (PORT, REF)]
    want = []
    for trs in (tx_results(PORT, n), tx_results(REF, n)[n - buffer:]):
        txi = PORT.txindex.TxIndexer(PORT.db.MemDB())
        for tr in trs:
            txi.index(tr)
        want.append(db_bytes(txi.db))
    assert port_db == want[0] and port_batches == 1
    assert ref_db == want[1] and ref_batches == buffer
