"""Port parity for the consensus WAL (consensus/wal.py): the four record
kinds and TimedWALMessage, the crc framing, rotation with its size
limits, repair's quarantine, search_for_end_height, segment_paths and
rotated_indices, and the wal.torn_write / wal.fsync failpoints, against
the JAX package.

Records are byte-equal with the reference's, and a WAL written by one
package is read back by the other, segment for segment. Tolerance:
exact."""

import os

import numpy as np
import pytest

from test_torch_execution import PACKAGES, PORT, REF, outcome


def messages(p, n: int = 24, seed: int = 7) -> list:
    """n seeded WAL messages of every kind, an EndHeightMessage every
    sixth."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = 1 + i // 6
        k = i % 6
        if k == 5:
            m = p.wal.EndHeightMessage(h)
        elif k in (0, 3):
            m = p.wal.MsgInfo(f"peer-{int(rng.integers(0, 9))}",
                              rng.bytes(int(rng.integers(0, 300))))
        elif k == 1:
            m = p.wal.TimeoutInfo(float(rng.integers(0, 3000)) / 1000, h,
                                  int(rng.integers(0, 3)), 3)
        else:
            m = p.wal.RoundStateMessage(h, int(rng.integers(0, 2)), k)
        out.append((m, 1_700_000_000_000_000_000 + i * 1_000_003))
    return out


def encode(p, msgs) -> list[bytes]:
    return [p.wal._encode_wal_msg(p.wal.TimedWALMessage(t, m))
            for m, t in msgs]


def summary(p, decoded) -> list:
    return [(type(m.msg).__name__, m.time_ns, vars(m.msg)) for m in decoded]


@pytest.mark.parametrize("kind", ["EndHeightMessage", "MsgInfo",
                                  "TimeoutInfo", "RoundStateMessage"])
def test_record_bytes_equal_reference(kind):
    got = []
    for p in (PORT, REF):
        msgs = [(m, t) for m, t in messages(p) if type(m).__name__ == kind]
        data = encode(p, msgs)
        back = [p.wal._decode_wal_msg(b) for b in data]
        got.append((data, summary(p, back)))
    assert got[0] == got[1] and got[0][0]


def write_wal(p, path, msgs, **limits):
    w = p.wal.WAL(path, **limits)
    for m, t in msgs:
        w.write(m, t)
    w.close()


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_files_written_by_one_package_read_by_the_other(tmp_path, writer,
                                                        reader):
    """Rotated segments and the head: equal bytes, and each package
    reads the other's records (decode_all, read_all, decode_iter)."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    paths = {}
    for k, p in ((writer, w), ("again", r)):
        paths[k] = str(tmp_path / k / "wal")
        write_wal(p, paths[k], messages(p, 60), head_size_limit=2048)
    segs = [p.wal.segment_paths(paths[k]) for k, p in ((writer, w),
                                                       ("again", r))]
    assert [os.path.basename(s) for s in segs[0]] == \
        [os.path.basename(s) for s in segs[1]] and len(segs[0]) > 2
    for a, b in zip(*segs):
        assert open(a, "rb").read() == open(b, "rb").read()
    read = r.wal.WAL(paths[writer])
    try:
        got = summary(r, read.read_all())
        head = summary(r, r.wal.WAL.decode_all(paths[writer]))
        lazy = summary(r, list(r.wal.WAL.decode_iter(paths[writer])))
    finally:
        read.close()
    assert got == summary(r, [r.wal.TimedWALMessage(t, m)
                              for m, t in messages(r, 60)])
    assert head == lazy == got[len(got) - len(head):]
    assert r.wal.rotated_indices(paths[writer]) == \
        w.wal.rotated_indices(paths[writer])


def test_total_size_limit_drops_the_oldest_segments(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "wal")
        write_wal(p, path, messages(p, 80), head_size_limit=1024,
                  total_size_limit=3000)
        got.append(([os.path.basename(s) for s in p.wal.segment_paths(path)],
                    [open(s, "rb").read() for s in p.wal.segment_paths(path)]))
    assert got[0] == got[1] and got[0][0][0] != "wal.000"


def test_search_for_end_height_across_segments(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "wal")
        write_wal(p, path, messages(p, 60), head_size_limit=1500)
        w = p.wal.WAL(path)
        try:
            got.append([(h, found, summary(p, tail))
                        for h in range(0, 12)
                        for tail, found in [w.search_for_end_height(h)]])
        finally:
            w.close()
    assert got[0] == got[1]
    assert [g[1] for g in got[0]] == [False] + [True] * 10 + [False]


@pytest.mark.parametrize("tail", [b"\xde\xad\xbe\xef-torn", b"\x00\x00\x00",
                                  b"\xff" * 12])
def test_repair_quarantines_the_same_tail(tmp_path, tail):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "wal")
        write_wal(p, path, messages(p, 10))
        with open(path, "ab") as f:
            f.write(tail)
        w = p.wal.WAL(path)
        try:
            first, second = w.repair(), w.repair()
            w.write(p.wal.EndHeightMessage(9), 5)
        finally:
            w.close()
        got.append((first, second, open(path, "rb").read(),
                     open(path + ".corrupt.000", "rb").read(),
                     outcome(lambda: p.wal.WAL.decode_all(path, strict=True)
                             and None)))
    assert got[0] == got[1] and got[0][:2] == (True, False)
    assert got[0][3] == tail


def test_strict_decode_and_size_limit_raise_as_the_reference(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "wal")
        write_wal(p, path, messages(p, 6))
        data = bytearray(open(path, "rb").read())
        data[20] ^= 0xFF
        open(path, "wb").write(bytes(data))
        w = p.wal.WAL(path)
        try:
            big = outcome(lambda: w.write(p.wal.MsgInfo("x", b"\x00" * (1 << 20)),
                                          0))
        finally:
            w.close()
        got.append((outcome(lambda: p.wal.WAL.decode_all(path, strict=True)),
                    len(p.wal.WAL.decode_all(path)), big))
    assert got[0] == got[1]
    assert got[0][0][0] == "WALCorruptionError"
    assert got[0][2][0] == "ValueError"


def test_torn_write_and_fsync_failpoints(tmp_path):
    """`corrupt` on wal.torn_write writes a bit-flipped, truncated frame
    that repair() then quarantines; `error` on wal.fsync raises from
    write_sync. Equal bytes and outcomes."""
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "wal")
        w = p.wal.WAL(path)
        try:
            w.write_sync(p.wal.EndHeightMessage(1), 1)
            p.failpoints.arm("wal.torn_write", "corrupt", count=1)
            w.write_sync(p.wal.EndHeightMessage(2), 2)
            p.failpoints.arm("wal.fsync", "error", count=1)
            fsync = outcome(lambda: w.write_sync(p.wal.EndHeightMessage(3), 3))
            raw = open(path, "rb").read()
            repaired = w.repair()
        finally:
            p.failpoints.disarm_all()
            w.close()
        got.append((fsync, raw, repaired,
                    [m.msg.height for m in p.wal.WAL.decode_all(path)]))
    assert got[0] == got[1]
    assert got[0][0] == ("FailpointError", "injected failpoint 'wal.fsync'")
    assert got[0][2] is True and got[0][3] == [1]
