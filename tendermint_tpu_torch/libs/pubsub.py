"""Event pub/sub with a query language (reference: libs/pubsub.py; Go
libs/pubsub).

Queries follow the reference DSL (libs/pubsub/query): conditions over
string-keyed event attributes joined by AND, e.g.

    tm.event = 'NewBlock' AND tx.height > 5 AND tx.hash CONTAINS 'ab'

Events are published with a message plus an attribute multimap
(key -> list of string values); a condition matches if ANY value for
the key satisfies it.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field


class QueryError(ValueError):
    pass


_TOKEN = re.compile(
    r"\s*(?:(?P<op><=|>=|=|<|>)|(?P<kw>AND|CONTAINS|EXISTS)\b|"
    r"(?P<str>'[^']*')|(?P<num>-?\d+(?:\.\d+)?)|(?P<key>[\w.\-/]+))"
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '<', '>', '<=', '>=', 'CONTAINS', 'EXISTS'
    value: str | float | None = None

    def matches(self, attrs: dict[str, list[str]]) -> bool:
        values = attrs.get(self.key)
        if values is None:
            return False
        if self.op == "EXISTS":
            return True
        for v in values:
            if self._match_one(v):
                return True
        return False

    def _match_one(self, v: str) -> bool:
        if self.op == "CONTAINS":
            return str(self.value) in v
        if self.op == "=":
            if isinstance(self.value, float):
                try:
                    return float(v) == self.value
                except ValueError:
                    return False
            return v == self.value
        try:
            lhs = float(v)
        except ValueError:
            return False
        rhs = float(self.value)  # type: ignore[arg-type]
        return {
            "<": lhs < rhs,
            ">": lhs > rhs,
            "<=": lhs <= rhs,
            ">=": lhs >= rhs,
        }[self.op]


class Query:
    """AND-composed conditions parsed from the DSL string."""

    def __init__(self, conditions: list[Condition], source: str = ""):
        self.conditions = conditions
        self._source = source or " AND ".join(
            f"{c.key} {c.op} {c.value!r}" for c in conditions
        )

    @classmethod
    def parse(cls, s: str) -> "Query":
        tokens = []
        pos = 0
        while pos < len(s):
            m = _TOKEN.match(s, pos)
            if not m or m.end() == pos:
                if s[pos:].strip():
                    raise QueryError(f"bad query near {s[pos:]!r}")
                break
            pos = m.end()
            kind = m.lastgroup
            tokens.append((kind, m.group(kind)))
        conds = []
        i = 0
        while i < len(tokens):
            if tokens[i] == ("kw", "AND"):
                i += 1
                continue
            if tokens[i][0] != "key":
                raise QueryError(f"expected key, got {tokens[i]!r}")
            key = tokens[i][1]
            if i + 1 >= len(tokens):
                raise QueryError("dangling key")
            kind, tok = tokens[i + 1]
            if (kind, tok) == ("kw", "EXISTS"):
                conds.append(Condition(key, "EXISTS"))
                i += 2
                continue
            if kind == "kw" and tok == "CONTAINS":
                if i + 2 >= len(tokens) or tokens[i + 2][0] != "str":
                    raise QueryError("CONTAINS needs a string")
                conds.append(Condition(key, "CONTAINS", tokens[i + 2][1][1:-1]))
                i += 3
                continue
            if kind != "op":
                raise QueryError(f"expected operator after {key}")
            if i + 2 >= len(tokens):
                raise QueryError("dangling operator")
            vkind, vtok = tokens[i + 2]
            if vkind == "str":
                value: str | float = vtok[1:-1]
            elif vkind == "num":
                value = float(vtok)
            else:
                raise QueryError(f"bad value {vtok!r}")
            conds.append(Condition(key, tok, value))
            i += 3
        if not conds:
            raise QueryError("empty query")
        return cls(conds, s)

    def matches(self, attrs: dict[str, list[str]]) -> bool:
        return all(c.matches(attrs) for c in self.conditions)

    def __str__(self) -> str:
        return self._source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))


ALL = Query([Condition("__all__", "EXISTS")], "__all__")
ALL.matches = lambda attrs: True  # type: ignore[method-assign]


@dataclass
class Message:
    data: object
    attrs: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    def __init__(self, query: Query, buffer: int):
        self.query = query
        self.queue: asyncio.Queue[Message] = asyncio.Queue(buffer)
        self.cancelled: asyncio.Event = asyncio.Event()

    async def next(self) -> Message:
        get = asyncio.ensure_future(self.queue.get())
        cancel = asyncio.ensure_future(self.cancelled.wait())
        done, pending = await asyncio.wait(
            [get, cancel], return_when=asyncio.FIRST_COMPLETED
        )
        for p in pending:
            p.cancel()
        if get in done:
            return get.result()
        raise asyncio.CancelledError("subscription cancelled")


class PubSub:
    """In-process event bus: subscribe by query, publish with attrs.

    Unlike the reference's buffered-channel semantics, a full subscriber
    queue drops the oldest message for that subscriber (slow consumers
    never stall consensus) — the same policy the reference applies via
    unsubscribe-on-overflow, without the forced resubscribe.
    """

    def __init__(self, buffer: int = 1024):
        self._buffer = buffer
        self._subs: dict[tuple[str, str], Subscription] = {}

    def subscribe(self, subscriber: str, query: Query) -> Subscription:
        key = (subscriber, str(query))
        if key in self._subs:
            raise ValueError(f"already subscribed: {key}")
        sub = Subscription(query, self._buffer)
        self._subs[key] = sub
        return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        key = (subscriber, str(query))
        sub = self._subs.pop(key, None)
        if sub is None:
            raise ValueError(f"not subscribed: {key}")
        sub.cancelled.set()

    def unsubscribe_all(self, subscriber: str) -> None:
        for key in [k for k in self._subs if k[0] == subscriber]:
            self._subs.pop(key).cancelled.set()

    def publish(self, data: object, attrs: dict[str, list[str]] | None = None) -> None:
        attrs = attrs or {}
        msg = Message(data, attrs)
        for sub in self._subs.values():
            if sub.query.matches(attrs):
                while True:
                    try:
                        sub.queue.put_nowait(msg)
                        break
                    except asyncio.QueueFull:
                        try:
                            sub.queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break

    @property
    def num_subscribers(self) -> int:
        return len(self._subs)
