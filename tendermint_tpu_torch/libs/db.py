"""Key-value database abstraction (reference: libs/db.py; the Go
reference delegates to tm-db, and store/store.go:33 and state/store.go
assume get/set/batch/iterate).

MemDB: a sorted in-memory map. SqliteDB: an ordered store on sqlite.
FileDB: a crash-safe append-only record log with an in-memory index —
every set/delete appends a crc-framed record; atomic batches append one
multi-record entry; compaction rewrites the live set. The files of both
are byte-compatible with the reference's."""

from __future__ import annotations

import bisect
import logging
import os
import struct
import zlib

logger = logging.getLogger("libs.db")


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


# FileDB record: u32 crc | u32 len | payload; payload = batch of
# (u8 op, u32 klen, key, [u32 vlen, value]) entries. op 0=set 1=del.
_HDR = struct.Struct("<II")


class SqliteDB(DB):
    """Ordered persistent KV store on sqlite — the tm-db/goleveldb
    analogue (reference state/store.go:223, store/store.go:248 assume
    ordered iteration + range deletes for pruning). Unlike FileDB the
    live set is NOT memory-resident and persistence is not an
    O(whole-DB) rewrite: restart cost and RSS are O(working set),
    chain length is bounded by disk, and pruning deletes ranges in
    place. sqlite WAL mode + synchronous=FULL gives FileDB's
    fsync-per-write durability."""

    _CHUNK = 512  # iteration page size
    SYNCHRONOUS = ("OFF", "NORMAL", "FULL")

    def __init__(self, path: str, synchronous: str = "FULL"):
        import sqlite3

        self.path = path
        synchronous = synchronous.upper()
        if synchronous not in self.SYNCHRONOUS:
            raise ValueError(
                f"db synchronous must be one of {self.SYNCHRONOUS}, "
                f"not {synchronous!r}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # autocommit mode; batches use explicit BEGIN IMMEDIATE.
        # check_same_thread off: the node is asyncio-single-threaded
        # but debug/tooling paths may touch a store from a worker
        # thread; sqlite itself is serialized-mode here.
        self._c = sqlite3.connect(path, isolation_level=None,
                                  check_same_thread=False)
        self._c.execute("PRAGMA journal_mode=WAL")
        # FULL (default) fsyncs the sqlite WAL on every commit — the
        # per-height durability the commit pipeline assumes. NORMAL/OFF
        # are opt-in (config base.db_synchronous) for replayable
        # non-validator workloads; a crash can then lose the tail.
        self._c.execute(f"PRAGMA synchronous={synchronous}")
        self._c.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            "k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID")

    def get(self, key: bytes) -> bytes | None:
        row = self._c.execute(
            "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return None if row is None else bytes(row[0])

    def set(self, key: bytes, value: bytes) -> None:
        from . import failpoints

        failpoints.hit("db.set")
        self._c.execute(
            "INSERT INTO kv (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v", (key, value))

    def delete(self, key: bytes) -> None:
        self._c.execute("DELETE FROM kv WHERE k = ?", (key,))

    def write_batch(self, ops) -> None:
        from . import failpoints

        failpoints.hit("db.set")
        self._c.execute("BEGIN IMMEDIATE")
        try:
            for k, v in ops:
                if v is None:
                    self._c.execute("DELETE FROM kv WHERE k = ?", (k,))
                else:
                    self._c.execute(
                        "INSERT INTO kv (k, v) VALUES (?, ?) "
                        "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                        (k, v))
            # COMMIT inside the guard: if it fails (disk full, BUSY)
            # the transaction must still be rolled back, or every
            # later BEGIN dies with "transaction within a transaction"
            self._c.execute("COMMIT")
        except BaseException:
            try:
                self._c.execute("ROLLBACK")
            except Exception:
                pass  # some COMMIT failures already ended the txn
            raise

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        # Stateless pagination (fresh statement per page, resuming
        # just past the last yielded key): callers may write between
        # yields — e.g. gather-then-prune loops — without invalidating
        # the scan.
        cur = start
        while True:
            if end is None:
                rows = self._c.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k "
                    "LIMIT ?", (cur, self._CHUNK)).fetchall()
            else:
                rows = self._c.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? "
                    "ORDER BY k LIMIT ?",
                    (cur, end, self._CHUNK)).fetchall()
            for k, v in rows:
                yield bytes(k), bytes(v)
            if len(rows) < self._CHUNK:
                return
            cur = bytes(rows[-1][0]) + b"\x00"  # k > last

    def close(self) -> None:
        self._c.close()


class FileDB(MemDB):
    """Log-structured persistent DB. The whole live set is mirrored in
    memory (fine at this scale; the reference's goleveldb caches
    comparably for its working set)."""

    COMPACT_RATIO = 4  # compact when log bytes > ratio * live bytes

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._live_bytes = 0
        self._log_bytes = 0
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + _HDR.size <= len(data):
            crc, ln = _HDR.unpack_from(data, pos)
            body = data[pos + _HDR.size : pos + _HDR.size + ln]
            if len(body) < ln or zlib.crc32(body) != crc:
                break  # torn tail from a crash: drop it
            self._apply_payload(body)
            pos += _HDR.size + ln
        if pos < len(data):
            # Torn tail from a crash (or a bad disk): QUARANTINE the
            # bytes to <db>.corrupt.NNN before truncating, like the
            # consensus WAL's repair() — a truncate that cut more than
            # a crash tail must leave the evidence for post-mortem,
            # never silently destroy it.
            tail = data[pos:]
            qpath = self._quarantine_path()
            with open(qpath, "wb") as qf:
                qf.write(tail)
                qf.flush()
                os.fsync(qf.fileno())
            with open(self.path, "r+b") as f:
                f.truncate(pos)
            logger.warning(
                "FileDB replay: quarantined %d torn tail bytes of %s "
                "to %s", len(tail), self.path, qpath)
        self._log_bytes = pos
        self._live_bytes = sum(len(k) + len(v) for k, v in self._m.items())

    QUARANTINE_SLOTS = 8

    def _quarantine_path(self) -> str:
        """First free `<path>.corrupt.NNN` slot, capped: a crash-
        looping node (chaos kill perturbations) must not accumulate
        quarantine files without bound. The earliest slots — the first
        evidence, usually the interesting one — are preserved; once
        all slots exist, the NEWEST slot is reused."""
        for n in range(self.QUARANTINE_SLOTS):
            p = f"{self.path}.corrupt.{n:03d}"
            if not os.path.exists(p):
                return p
        return f"{self.path}.corrupt.{self.QUARANTINE_SLOTS - 1:03d}"

    def _apply_payload(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            op = body[pos]
            klen = struct.unpack_from("<I", body, pos + 1)[0]
            key = body[pos + 5 : pos + 5 + klen]
            pos += 5 + klen
            if op == 0:
                vlen = struct.unpack_from("<I", body, pos)[0]
                val = body[pos + 4 : pos + 4 + vlen]
                pos += 4 + vlen
                super().set(key, val)
            else:
                super().delete(key)

    def _append(self, payload: bytes) -> None:
        """Write + fsync ONE crc-framed record. Called BEFORE the ops
        are applied to the in-memory mirror: an append that raises
        (injected db.set error, disk full) must leave memory and disk
        agreeing, or the process would serve state the log never saw
        (a divergence that "heals" wrong on restart)."""
        from . import failpoints

        failpoints.hit("db.set")
        rec = _HDR.pack(zlib.crc32(payload), len(payload)) + payload
        self._f.write(rec)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._log_bytes += len(rec)

    def _maybe_compact(self) -> None:
        # separate from _append: compaction rewrites the log from the
        # in-memory mirror, so it must only ever run AFTER the ops of
        # the record just appended have been applied to memory —
        # compacting in between would drop them from the rewritten log.
        if (
            self._log_bytes > 1 << 20
            and self._log_bytes > self.COMPACT_RATIO * max(self._live_bytes, 1)
        ):
            self.compact()

    @staticmethod
    def _enc_set(key: bytes, value: bytes) -> bytes:
        return b"\x00" + struct.pack("<I", len(key)) + key + struct.pack(
            "<I", len(value)
        ) + value

    @staticmethod
    def _enc_del(key: bytes) -> bytes:
        return b"\x01" + struct.pack("<I", len(key)) + key

    def set(self, key: bytes, value: bytes) -> None:
        self._append(self._enc_set(key, value))
        old = self._m.get(key)
        super().set(key, value)
        self._live_bytes += len(value) - (len(old) if old is not None else -len(key))
        self._maybe_compact()

    def delete(self, key: bytes) -> None:
        self._append(self._enc_del(key))
        old = self._m.get(key)
        if old is not None:
            self._live_bytes -= len(key) + len(old)
        super().delete(key)
        self._maybe_compact()

    def write_batch(self, ops) -> None:
        """ONE crc-framed record for the whole batch: a crash replays
        to all of the batch or none of it (the record's crc fails as a
        unit — _replay can never accept a half-applied batch). The
        encode → append → apply order means a failed append leaves the
        in-memory mirror untouched too."""
        ops = list(ops)
        payload = bytearray()
        for k, v in ops:
            payload += self._enc_del(k) if v is None else self._enc_set(k, v)
        if not payload:
            return
        self._append(bytes(payload))
        for k, v in ops:
            old = self._m.get(k)
            if v is None:
                if old is not None:
                    self._live_bytes -= len(k) + len(old)
                MemDB.delete(self, k)
            else:
                self._live_bytes += len(v) - (
                    len(old) if old is not None else -len(k)
                )
                MemDB.set(self, k, v)
        self._maybe_compact()

    def compact(self) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            size = 0
            for k in sorted(self._m):
                payload = self._enc_set(k, self._m[k])
                rec = _HDR.pack(zlib.crc32(payload), len(payload)) + payload
                f.write(rec)
                size += len(rec)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._log_bytes = size

    def close(self) -> None:
        self._f.close()
