"""Transaction indexer (reference: state/txindex.py; Go state/txindex/).

IndexerService subscribes to the EventBus Tx stream and writes each
TxResult into a kv index: primary record by tx hash, secondary keys
for height and for every ABCI event attribute (`type.key=value`), so
`tx_search` can answer the same query language the pubsub uses."""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass

from ..crypto import tmhash
from ..libs.pubsub import Query
from ..types.events import EventDataTx, query_for_event

logger = logging.getLogger("txindex")

_PRIMARY = b"tx/"
_BY_HEIGHT = b"txh/"
_BY_EVENT = b"txe/"


@dataclass
class TxResult:
    height: int
    index: int
    tx: bytes
    result: dict

    def hash(self) -> bytes:
        return tmhash.sum256(self.tx)


class TxIndexer:
    """kv indexer (reference: state/txindex/kv/kv.go)."""

    def __init__(self, db):
        self.db = db

    def index(self, tr: TxResult) -> None:
        self.db.write_batch(self._ops(tr))

    def index_batch(self, trs: list[TxResult]) -> None:
        """Every result in one db batch: one append (and one fsync on a
        durable db) for the lot (Go kv.go AddBatch)."""
        self.db.write_batch([op for tr in trs for op in self._ops(tr)])

    def _ops(self, tr: TxResult) -> list[tuple[bytes, bytes]]:
        h = tr.hash()
        payload = json.dumps({
            "height": tr.height, "index": tr.index,
            "tx": tr.tx.hex(), "result": tr.result,
        }).encode()
        ops = [(_PRIMARY + h, payload),
               (_BY_HEIGHT + _u64(tr.height) + _u32(tr.index) + h, b"")]
        for ev in tr.result.get("events", []):
            etype = ev.get("type", "")
            for attr in ev.get("attributes", []):
                k, v = attr.get("key", ""), attr.get("value", "")
                if not etype or not k:
                    continue
                composite = f"{etype}.{k}={v}".encode()
                ops.append((_BY_EVENT + composite + b"/" +
                            _u64(tr.height) + _u32(tr.index) + h, b""))
        return ops

    def get(self, tx_hash: bytes) -> TxResult | None:
        raw = self.db.get(_PRIMARY + tx_hash)
        if raw is None:
            return None
        d = json.loads(raw)
        return TxResult(d["height"], d["index"],
                        bytes.fromhex(d["tx"]), d["result"])

    def search(self, query: Query) -> list[TxResult]:
        """Equality conditions narrow via the secondary indexes and are
        intersected; every other operator (ranges, CONTAINS, EXISTS) is
        applied as a post-filter. A query with no equality condition
        scans the primary records (reference kv.go Search)."""
        candidate_sets: list[set[bytes]] = []
        for cond in query.conditions:
            if cond.op != "=":
                continue
            if cond.key == "tx.height":
                h = _height_literal(cond.value)
                hashes = set() if h is None or h < 0 else {
                    k[-32:] for k, _ in self.db.iterate_prefix(
                        _BY_HEIGHT + _u64(h))
                }
            else:
                # Exact-composite match: the remainder after the
                # composite must be exactly "/" + u64 + u32 + hash —
                # a stored value that merely EXTENDS the queried one
                # past a "/" (paths, denoms) leaves a longer
                # remainder and is rejected.
                prefix = _BY_EVENT + \
                    f"{cond.key}={_fmt_value(cond.value)}".encode()
                rem = 1 + 8 + 4 + 32
                hashes = {
                    k[-32:] for k, _ in self.db.iterate_prefix(prefix)
                    if len(k) == len(prefix) + rem and
                    k[len(prefix):len(prefix) + 1] == b"/"
                }
            candidate_sets.append(hashes)
        if candidate_sets:
            hits = set.intersection(*candidate_sets)
        else:
            hits = {k[len(_PRIMARY):]
                    for k, _ in self.db.iterate_prefix(_PRIMARY)}
        out = [self.get(h) for h in sorted(hits)]
        results = [t for t in out if t is not None]
        for cond in query.conditions:
            if cond.op == "=":
                continue
            results = [
                t for t in results
                if cond.matches({cond.key: vals} if
                                (vals := _attr_values(t, cond)) else {})
            ]
        results.sort(key=lambda t: (t.height, t.index))
        return results


def _attr_values(tr: TxResult, cond) -> list[str]:
    if cond.key == "tx.height":
        return [str(tr.height)]
    if cond.key == "tx.hash":
        return [tr.hash().hex().upper()]
    out = []
    for ev in tr.result.get("events", []):
        for attr in ev.get("attributes", []):
            if f"{ev.get('type')}.{attr.get('key')}" == cond.key:
                out.append(attr.get("value", ""))
    return out


def _height_literal(v) -> int | None:
    """Exact-integer height from a query literal; None when the
    literal can't match any height (non-numeric string, fractional
    float) — int() truncation would turn `height = 3.5` into a wrong
    match at 3, and int('abc') would escape as an internal error."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return int(f) if f.is_integer() else None


def _fmt_value(v) -> str:
    """Render a query literal the way event attributes are stored:
    Query.parse turns unquoted numbers into floats, but ABCI event
    attribute values are strings — `amount = 100` must produce the
    composite `amount=100`, not `amount=100.0`."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _u64(v: int) -> bytes:
    return v.to_bytes(8, "big")


def _u32(v: int) -> bytes:
    return v.to_bytes(4, "big")


_BLK_PRIMARY = b"blk/"
_BLK_EVENT = b"blke/"


class BlockIndexer:
    """Indexes BeginBlock/EndBlock events per height so block_search
    can answer event queries (later-v0.34.x state/indexer/block/kv —
    the pinned reference predates the route; semantics match the
    released version: `block.height` is implicit, every event
    attribute is searchable as `type.key=value`)."""

    def __init__(self, db):
        self.db = db

    def index(self, height: int, result_begin_block: dict,
              result_end_block: dict) -> None:
        ops = [(_BLK_PRIMARY + _u64(height), b"")]
        for res in (result_begin_block, result_end_block):
            for ev in (res or {}).get("events", []):
                etype = ev.get("type", "")
                for attr in ev.get("attributes", []):
                    k, v = attr.get("key", ""), attr.get("value", "")
                    if not etype or not k:
                        continue
                    composite = f"{etype}.{k}={v}".encode()
                    ops.append((_BLK_EVENT + composite + b"/" +
                                _u64(height), b""))
        self.db.write_batch(ops)

    def has(self, height: int) -> bool:
        return self.db.get(_BLK_PRIMARY + _u64(height)) is not None

    def search(self, query: Query) -> list[int]:
        """Heights matching the query, ascending. Equality conditions
        narrow via the index; other operators post-filter (which for
        block queries can only reference block.height or indexed
        attributes of candidate heights)."""
        candidate_sets: list[set[int]] = []
        for cond in query.conditions:
            if cond.op != "=":
                continue
            if cond.key == "block.height":
                h = _height_literal(cond.value)
                candidate_sets.append(
                    {h} if h is not None and h >= 0 and self.has(h)
                    else set())
            else:
                # exact-composite match (see TxIndexer.search): the
                # remainder must be exactly "/" + u64(height)
                prefix = _BLK_EVENT + \
                    f"{cond.key}={_fmt_value(cond.value)}".encode()
                candidate_sets.append({
                    int.from_bytes(k[-8:], "big")
                    for k, _ in self.db.iterate_prefix(prefix)
                    if len(k) == len(prefix) + 9 and
                    k[len(prefix):len(prefix) + 1] == b"/"
                })
        if candidate_sets:
            hits = set.intersection(*candidate_sets)
        else:
            hits = {int.from_bytes(k[len(_BLK_PRIMARY):], "big")
                    for k, _ in self.db.iterate_prefix(_BLK_PRIMARY)}
        heights = sorted(hits)
        for cond in query.conditions:
            if cond.op == "=":
                continue
            if cond.key == "block.height":
                heights = [h for h in heights
                           if cond.matches({"block.height": [str(h)]})]
            else:
                # One prefix scan bucketed by height (not a rescan per
                # candidate — that is O(heights x index entries)).
                # Empty value list -> empty attrs (not {key: []}), so
                # EXISTS on a never-emitted event matches nothing
                # (same guard as TxIndexer.search above).
                by_height = self._attr_values_by_height(cond.key)
                heights = [
                    h for h in heights
                    if cond.matches({cond.key: vals} if
                                    (vals := by_height.get(h)) else {})
                ]
        return heights

    def _attr_values_by_height(self, key: str) -> dict[int, list[str]]:
        prefix = _BLK_EVENT + key.encode() + b"="
        out: dict[int, list[str]] = {}
        for k, _ in self.db.iterate_prefix(prefix):
            # layout: prefix + value + "/" + u64(height)
            if len(k) < len(prefix) + 9 or k[-9:-8] != b"/":
                continue
            h = int.from_bytes(k[-8:], "big")
            out.setdefault(h, []).append(
                k[len(prefix):-9].decode("utf-8", "replace"))
        return out


class IndexerService:
    """Bridges EventBus → TxIndexer
    (reference: state/txindex/indexer_service.go).

    Its Tx subscription is unbounded and each wake-up indexes every
    queued Tx event in one batch. The JAX package's service takes the
    bus's drop-oldest queue of 1024 and writes one batch a tx, so a
    durable db's fsync a tx lets it fall behind under load and lose the
    oldest events from the index for good (ROADMAP Queue C); Go's
    service subscribes unbuffered and never loses one."""

    SUBSCRIBER = "tx-indexer"

    def __init__(self, indexer: TxIndexer, event_bus,
                 block_indexer: BlockIndexer | None = None):
        self.indexer = indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus

    def start(self) -> None:
        import asyncio

        self._sub = self.event_bus.subscribe(
            self.SUBSCRIBER, query_for_event("Tx"), buffer=0)
        self._blk_sub = self.event_bus.subscribe(
            self.SUBSCRIBER, query_for_event("NewBlock")) \
            if self.block_indexer is not None else None
        loop = asyncio.get_running_loop()
        self._task = loop.create_task(self._run(), name="tx-indexer")
        self._blk_task = loop.create_task(
            self._run_blocks(), name="block-indexer") \
            if self._blk_sub is not None else None

    def stop(self) -> None:
        self.event_bus.unsubscribe_all(self.SUBSCRIBER)
        for t in (getattr(self, "_task", None),
                  getattr(self, "_blk_task", None)):
            if t is not None:
                t.cancel()

    async def _run(self) -> None:
        import asyncio

        while True:
            try:
                msgs = [await self._sub.next()]
            except asyncio.CancelledError:
                return
            while not self._sub.queue.empty():
                msgs.append(self._sub.queue.get_nowait())
            trs = [TxResult(m.data.height, m.data.index, m.data.tx,
                            m.data.result)
                   for m in msgs if isinstance(m.data, EventDataTx)]
            if trs:
                try:
                    self.indexer.index_batch(trs)
                except Exception:
                    logger.exception("failed to index %d txs at heights "
                                     "%d-%d", len(trs), trs[0].height,
                                     trs[-1].height)

    async def _run_blocks(self) -> None:
        import asyncio

        from ..types.events import EventDataNewBlock

        while True:
            try:
                msg = await self._blk_sub.next()
            except asyncio.CancelledError:
                return
            data = msg.data
            if isinstance(data, EventDataNewBlock):
                try:
                    self.block_indexer.index(
                        data.block.header.height,
                        data.result_begin_block, data.result_end_block)
                except Exception:
                    logger.exception("failed to index block events")
