"""Key-value database abstraction (reference: libs/db.py; the Go
reference delegates to tm-db, and store/store.go:33 and state/store.go
assume get/set/batch/iterate).

MemDB: a sorted in-memory map. The reference's persistent stores
(SqliteDB, FileDB) come with the node's assembly."""

from __future__ import annotations

import bisect


class DB:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def write_batch(self, ops: list[tuple[bytes, bytes | None]]) -> None:
        """Atomically apply [(key, value-or-None-to-delete)]."""
        raise NotImplementedError

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        """Yield (key, value) with start <= key < end, key-ascending."""
        raise NotImplementedError

    def iterate_prefix(self, prefix: bytes):
        end = _prefix_end(prefix)
        return self.iterate(prefix, end)

    def close(self) -> None:
        pass


def _prefix_end(prefix: bytes) -> bytes | None:
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] != 0xFF:
            p[i] += 1
            return bytes(p[: i + 1])
    return None  # all 0xff: no upper bound


class MemDB(DB):
    def __init__(self):
        self._m: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted view, rebuilt lazily
        self._dirty = False

    def get(self, key: bytes) -> bytes | None:
        return self._m.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._m:
            self._dirty = True
        self._m[key] = value

    def delete(self, key: bytes) -> None:
        if self._m.pop(key, None) is not None:
            self._dirty = True

    def write_batch(self, ops) -> None:
        for k, v in ops:
            if v is None:
                self.delete(k)
            else:
                self.set(k, v)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        if self._dirty:
            self._keys = sorted(self._m)
            self._dirty = False
        i = bisect.bisect_left(self._keys, start)
        while i < len(self._keys):
            k = self._keys[i]
            if end is not None and k >= end:
                return
            if k in self._m:  # may have been deleted since sort
                yield k, self._m[k]
            i += 1
