"""Trusted light-block store (reference: light/store.py; Go
light/store/db/db.go).

Persists verified LightBlocks keyed by height, under the reference's
keys and JSON bytes; the client resumes from the highest trusted block
after restart."""

from __future__ import annotations

import json

from ..state.store import _valset_from_json, _valset_to_json
from ..types.block import Commit, Header
from .types import LightBlock, SignedHeader

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    def __init__(self, db):
        self.db = db
        # Highest saved height, maintained incrementally after the
        # first scan: the client calls latest() on every verify
        # request, and a scan of the whole prefix each time would make
        # a request cost O(stored heights). None = unknown (not yet
        # scanned, or invalidated by a delete/prune that may have
        # removed the maximum).
        self._latest: int | None = None

    def save(self, lb: LightBlock) -> None:
        payload = json.dumps({
            "header": lb.signed_header.header.to_proto().finish().hex(),
            "commit": lb.signed_header.commit.to_bytes().hex(),
            "validators": _valset_to_json(lb.validator_set),
        }).encode()
        self.db.set(_key(lb.height()), payload)
        if self._latest is not None:
            self._latest = max(self._latest, lb.height())

    def get(self, height: int) -> LightBlock | None:
        raw = self.db.get(_key(height))
        if raw is None:
            return None
        d = json.loads(raw)
        return LightBlock(
            SignedHeader(Header.from_bytes(bytes.fromhex(d["header"])),
                         Commit.from_bytes(bytes.fromhex(d["commit"]))),
            _valset_from_json(d["validators"]),
        )

    def latest(self) -> LightBlock | None:
        latest_h = self.latest_height()
        return self.get(latest_h) if latest_h else None

    def latest_height(self) -> int:
        if self._latest is None:
            best = 0
            for k, _ in self.db.iterate_prefix(_PREFIX):
                h = int.from_bytes(k[len(_PREFIX):], "big")
                best = max(best, h)
            self._latest = best
        return self._latest

    def lowest_height(self) -> int:
        for k, _ in self.db.iterate_prefix(_PREFIX):
            return int.from_bytes(k[len(_PREFIX):], "big")
        return 0

    def heights(self) -> list[int]:
        return [int.from_bytes(k[len(_PREFIX):], "big")
                for k, _ in self.db.iterate_prefix(_PREFIX)]

    def delete(self, height: int) -> None:
        self.db.delete(_key(height))
        if self._latest is not None and height >= self._latest:
            # the cached maximum may be gone; rescan on next read
            self._latest = None

    def prune(self, keep: int) -> None:
        hs = self.heights()
        for h in hs[:-keep] if keep else hs:
            self.db.delete(_key(h))
        # pruning keeps the TOP `keep` heights, so the maximum
        # survives when keep > 0 — but a full prune empties the store
        if not keep:
            self._latest = None
