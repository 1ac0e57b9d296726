"""Consensus WAL (reference: consensus/wal.py; Go consensus/wal.go).

Append-only fsync'd log of everything the consensus state machine acts
on, written BEFORE acting — crash recovery replays the tail of the log
to rebuild in-flight round state. Record framing matches the
reference's shape (wal.go:288): crc32 + length + payload, with a hard
per-message size bound. An EndHeightMessage delimits each committed
height (wal.go:42); recovery seeks the last one (wal.go:231). The
records are byte-equal with the reference's; each write_sync's fsync is
a wal.fsync span."""

from __future__ import annotations

import logging
import os
import struct
import zlib
from dataclasses import dataclass

logger = logging.getLogger("wal")

from ..encoding.proto import Reader, Writer
from ..libs import failpoints, tracing

MAX_MSG_SIZE = 1 << 20  # 1MB, reference wal.go maxMsgSizeBytes


@dataclass
class EndHeightMessage:
    height: int


@dataclass
class MsgInfo:
    """A peer or internal consensus message (votes/proposals/parts),
    carried as its consensus-codec bytes."""

    peer_id: str
    msg_bytes: bytes


@dataclass
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int


@dataclass
class RoundStateMessage:
    """Step-transition marker (the reference WALs EventDataRoundState)."""

    height: int
    round: int
    step: int


@dataclass
class TimedWALMessage:
    time_ns: int
    msg: object


def _encode_wal_msg(m: TimedWALMessage) -> bytes:
    w = Writer()
    w.varint(1, m.time_ns)
    inner = m.msg
    if isinstance(inner, EndHeightMessage):
        w.message(2, Writer().varint(1, inner.height))
    elif isinstance(inner, MsgInfo):
        iw = Writer()
        iw.string(1, inner.peer_id)
        iw.bytes(2, inner.msg_bytes)
        w.message(3, iw)
    elif isinstance(inner, TimeoutInfo):
        iw = Writer()
        iw.varint(1, int(inner.duration_s * 1e9))
        iw.varint(2, inner.height)
        iw.varint(3, inner.round, skip_zero=False)
        iw.varint(4, inner.step)
        w.message(4, iw)
    elif isinstance(inner, RoundStateMessage):
        iw = Writer()
        iw.varint(1, inner.height)
        iw.varint(2, inner.round, skip_zero=False)
        iw.varint(3, inner.step)
        w.message(5, iw)
    else:
        raise TypeError(f"unknown WAL message {type(inner).__name__}")
    return w.finish()


def _decode_wal_msg(data: bytes) -> TimedWALMessage:
    r = Reader(data)
    time_ns = 0
    msg: object | None = None
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            time_ns = r.varint()
        elif f == 2:
            rr = Reader(r.bytes())
            height = 0
            while not rr.at_end():
                ff, wwt = rr.field()
                if ff == 1:
                    height = rr.varint()
                else:
                    rr.skip(wwt)
            msg = EndHeightMessage(height)
        elif f == 3:
            rr = Reader(r.bytes())
            peer, mb = "", b""
            while not rr.at_end():
                ff, wwt = rr.field()
                if ff == 1:
                    peer = rr.string()
                elif ff == 2:
                    mb = rr.bytes()
                else:
                    rr.skip(wwt)
            msg = MsgInfo(peer, mb)
        elif f == 4:
            rr = Reader(r.bytes())
            dur = height = round_ = step = 0
            while not rr.at_end():
                ff, wwt = rr.field()
                if ff == 1:
                    dur = rr.varint()
                elif ff == 2:
                    height = rr.varint()
                elif ff == 3:
                    round_ = rr.varint()
                elif ff == 4:
                    step = rr.varint()
                else:
                    rr.skip(wwt)
            msg = TimeoutInfo(dur / 1e9, height, round_, step)
        elif f == 5:
            rr = Reader(r.bytes())
            height = round_ = step = 0
            while not rr.at_end():
                ff, wwt = rr.field()
                if ff == 1:
                    height = rr.varint()
                elif ff == 2:
                    round_ = rr.varint()
                elif ff == 3:
                    step = rr.varint()
                else:
                    rr.skip(wwt)
            msg = RoundStateMessage(height, round_, step)
        else:
            r.skip(wt)
    if msg is None:
        raise ValueError("WAL message missing payload")
    return TimedWALMessage(time_ns, msg)


_FRAME = struct.Struct(">II")  # crc32, length


class WALCorruptionError(Exception):
    pass


def rotated_indices(path: str) -> list[int]:
    """Indices of rotated segments next to a WAL head path. Module
    level (not a method) so read-only consumers — replay-console —
    can enumerate segments without opening the head for append."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path) + "."
    out = []
    for name in os.listdir(d):
        if name.startswith(base) and name[len(base):].isdigit():
            out.append(int(name[len(base):]))
    return sorted(out)


def segment_paths(path: str) -> list[str]:
    """All segment files for a WAL head path, oldest first, head last."""
    return [f"{path}.{i:03d}" for i in rotated_indices(path)] + [path]


class WAL:
    """File-backed WAL with size-bounded rotation. write() buffers;
    write_sync() flushes + fsyncs. The consensus loop write_sync's
    before acting on any message that could change state (matching
    BaseWAL.WriteSync, wal.go:201).

    Rotation mirrors autofile.Group (reference consensus/wal.go:97 on
    libs/autofile/group.go:301): the head file lives at `path`; when
    it crosses head_size_limit it is renamed to `path.NNN` (NNN
    ascending, oldest = smallest) and a fresh head opens. When the
    segments together exceed total_size_limit the oldest are deleted
    (group.go:268 checkTotalSizeLimit) — replay data for long-
    committed heights is owned by the block/state stores, not the
    WAL. Rotation happens between records, so every segment is a
    clean record sequence; only the head can have a torn tail."""

    HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # group.go:21
    TOTAL_SIZE_LIMIT = 1 << 30          # group.go:22

    def __init__(self, path: str, head_size_limit: int | None = None,
                 total_size_limit: int | None = None):
        self.path = path
        self.head_size_limit = head_size_limit or self.HEAD_SIZE_LIMIT
        self.total_size_limit = total_size_limit or self.TOTAL_SIZE_LIMIT
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._head_size = os.path.getsize(path)

    # -- segments --

    def _rotated_indices(self) -> list[int]:
        return rotated_indices(self.path)

    def segment_paths(self) -> list[str]:
        """All segment files, oldest first, head last."""
        return segment_paths(self.path)

    def _rotate(self) -> None:
        self.flush_and_sync()
        self._f.close()
        idxs = self._rotated_indices()
        nxt = (idxs[-1] + 1) if idxs else 0
        os.rename(self.path, f"{self.path}.{nxt:03d}")
        self._f = open(self.path, "ab")
        self._head_size = 0
        # total-size bound: drop oldest segments
        segs = self.segment_paths()
        sizes = {p: os.path.getsize(p) for p in segs if os.path.exists(p)}
        total = sum(sizes.values())
        for p in segs[:-1]:
            if total <= self.total_size_limit:
                break
            total -= sizes.get(p, 0)
            os.unlink(p)

    # -- writing --

    def write(self, msg: object, time_ns: int = 0) -> None:
        data = _encode_wal_msg(TimedWALMessage(time_ns, msg))
        if len(data) > MAX_MSG_SIZE:
            raise ValueError(f"WAL message too big: {len(data)}")
        frame = _FRAME.pack(zlib.crc32(data), len(data)) + data
        # chaos: `corrupt` writes a bit-flipped/truncated frame — the
        # torn-write shape repair() must quarantine on the next boot
        frame = failpoints.hit("wal.torn_write", payload=frame)
        self._f.write(frame)
        self._head_size += len(frame)
        if self._head_size >= self.head_size_limit:
            self._rotate()

    def write_sync(self, msg: object, time_ns: int = 0) -> None:
        self.write(msg, time_ns)
        with tracing.TRACER.span(tracing.WAL_FSYNC):
            self.flush_and_sync()

    def flush_and_sync(self) -> None:
        failpoints.hit("wal.fsync")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.flush_and_sync()
        except (OSError, ValueError):
            pass
        self._f.close()

    # -- reading --

    @staticmethod
    def _read_bytes(path: str) -> bytes:
        """One atomic read of a segment's current contents. Decoding
        and size accounting below both work off THIS byte string —
        never a re-stat of the live file (see _decode_file)."""
        if not os.path.exists(path):
            return b""
        with open(path, "rb") as f:
            return f.read()

    @staticmethod
    def _iter_records(path: str, strict: bool = False):
        """Yield (TimedWALMessage, consumed_bytes_after) one record at
        a time. On a corrupt/torn record, stop (strict=False — crash
        tails are expected) or raise (strict=True)."""
        yield from WAL._iter_data(WAL._read_bytes(path), strict)

    @staticmethod
    def _iter_data(data: bytes, strict: bool = False):
        pos = 0
        while pos + _FRAME.size <= len(data):
            crc, ln = _FRAME.unpack_from(data, pos)
            if ln > MAX_MSG_SIZE:
                if strict:
                    raise WALCorruptionError(f"record length {ln} too big")
                return
            body = data[pos + _FRAME.size : pos + _FRAME.size + ln]
            if len(body) < ln or zlib.crc32(body) != crc:
                if strict:
                    raise WALCorruptionError("crc mismatch / torn record")
                return
            try:
                msg = _decode_wal_msg(body)
            except ValueError:
                if strict:
                    raise
                return
            pos += _FRAME.size + ln
            yield msg, pos

    @staticmethod
    def _decode_file(path: str,
                     strict: bool = False
                     ) -> tuple[list[TimedWALMessage], int, int]:
        """Every record of one file; returns (messages,
        consumed_bytes, bytes_read).

        The size reported is len() of the bytes actually decoded, NOT
        a fresh stat: a record appended between the read and a re-stat
        would make size > consumed and repair() would truncate the
        perfectly valid new record off a healthy WAL."""
        data = WAL._read_bytes(path)
        out: list[TimedWALMessage] = []
        pos = 0
        for msg, pos in WAL._iter_data(data, strict):
            out.append(msg)
        return out, pos, len(data)

    @staticmethod
    def decode_all(path: str, strict: bool = False) -> list[TimedWALMessage]:
        return WAL._decode_file(path, strict)[0]

    @staticmethod
    def decode_iter(path: str, strict: bool = False):
        """Record-at-a-time generator: peak memory is one segment's
        raw bytes + ONE decoded message (decode_all materializes the
        whole list — wrong for the replay console over a big WAL)."""
        for msg, _ in WAL._iter_records(path, strict):
            yield msg

    def _read_segment(self, path: str) -> list[TimedWALMessage]:
        """One segment's valid records. Rotated segments were sealed
        at a record boundary, so mid-file corruption is real — the
        valid prefix is still returned (dropping it could erase the
        very EndHeightMessage recovery is looking for), with a
        warning for the lost tail. The head's torn tail is expected
        (crash) and not warned about here; repair() handles it."""
        msgs, consumed, size = self._decode_file(path)
        if consumed < size and path != self.path:
            logger.warning(
                "corrupt rotated WAL segment %s: %d of %d bytes "
                "unreadable after record %d",
                path, size - consumed, size, len(msgs))
        return msgs

    def read_all(self) -> list[TimedWALMessage]:
        """Every valid record across all segments, oldest first."""
        out: list[TimedWALMessage] = []
        for p in self.segment_paths():
            out.extend(self._read_segment(p))
        return out

    def search_for_end_height(self, height: int) -> tuple[list[TimedWALMessage], bool]:
        """Messages AFTER the EndHeightMessage for `height` (i.e. the
        in-flight messages of height+1), and whether it was found
        (reference wal.go:231 SearchForEndHeight) — spanning segment
        boundaries: the marker may sit in a rotated segment while the
        in-flight tail continues in the head. Segments are scanned
        NEWEST first and the scan stops at the first (newest) segment
        containing the marker, so boot cost is ~one segment, not the
        whole group (the group can be 1 GiB). Two phases so the
        marker-ABSENT case (a normal boot path after fast sync) holds
        at most one decoded segment in memory at a time instead of
        accumulating the whole group."""
        segs = self.segment_paths()
        found_seg = None
        for si in range(len(segs) - 1, -1, -1):
            if any(isinstance(m.msg, EndHeightMessage)
                   and m.msg.height == height
                   for m in self._read_segment(segs[si])):
                found_seg = si
                break
        if found_seg is None:
            return [], False
        # Rebuild the tail: marker segment + everything newer. The
        # common case (marker in the head) re-decodes one file.
        tail: list[TimedWALMessage] = []
        for si in range(found_seg, len(segs)):
            msgs = self._read_segment(segs[si])
            if si == found_seg:
                idx = max(i for i, m in enumerate(msgs)
                          if isinstance(m.msg, EndHeightMessage)
                          and m.msg.height == height)
                msgs = msgs[idx + 1:]
            tail.extend(msgs)
        return tail, True

    def repair(self) -> bool:
        """Cut a corrupted tail off the HEAD segment, keeping every
        valid record (reference: consensus/state.go:2217 repairWalFile
        — crashes only ever tear the file being appended). Returns
        True if anything was cut. The cut point is the decoder's
        consumed-bytes offset — the exact on-disk boundary,
        independent of whether re-encoding would be byte-identical.

        The tail is QUARANTINED, not deleted: the bytes move to
        `<path>.corrupt.NNN` before the truncate, so a repair that cut
        more than a crash tail (bad disk, injected mid-record torn
        write) leaves the evidence on disk for post-mortem instead of
        silently destroying it."""
        _, consumed, size = self._decode_file(self.path)
        if size <= consumed:
            return False
        self._f.close()
        with open(self.path, "rb") as f:
            f.seek(consumed)
            tail = f.read()
        qpath = self._quarantine_path()
        with open(qpath, "wb") as qf:
            qf.write(tail)
            qf.flush()
            os.fsync(qf.fileno())
        with open(self.path, "r+b") as f:
            f.truncate(consumed)
        logger.warning(
            "WAL repair: quarantined %d corrupt tail bytes of %s "
            "to %s", len(tail), self.path, qpath)
        self._f = open(self.path, "ab")
        self._head_size = consumed
        return True

    def _quarantine_path(self) -> str:
        """First free `<path>.corrupt.NNN` — repeated repairs (chaos
        sweeps, flaky disks) must not overwrite earlier evidence."""
        n = 0
        while True:
            p = f"{self.path}.corrupt.{n:03d}"
            if not os.path.exists(p):
                return p
            n += 1
