"""Port parity for the persistent KV stores (libs/db.py SqliteDB and
FileDB) and config.BaseConfig's store settings, against the JAX package.

The same seeded operations (sets, deletes, atomic batches, enough
churn to compact a FileDB) run in both packages: the files must be
byte-equal (FileDB) or hold equal rows (SqliteDB), each package must read
the other's file back, a torn FileDB batch must replay to none of it in
both with the same `.corrupt.NNN` quarantine, and the `db.set` failpoint
must leave memory and disk agreeing. Tolerance: exact."""

import os

import numpy as np
import pytest

from test_torch_execution import PACKAGES, PORT, REF, db_bytes, outcome


def ops(seed: int, n: int = 400) -> list:
    """Seeded ("set", k, v) / ("del", k) / ("batch", [...]) operations
    over a few hundred keys with shared prefixes."""
    rng = np.random.default_rng(seed)
    out = []
    keys = [b"k/%03d" % i for i in range(120)] + [b"\xff\xfe%d" % i
                                                  for i in range(8)]
    for _ in range(n):
        r = rng.random()
        k = keys[int(rng.integers(0, len(keys)))]
        if r < 0.6:
            out.append(("set", k, rng.bytes(int(rng.integers(0, 200)))))
        elif r < 0.8:
            out.append(("del", k))
        else:
            out.append(("batch", [
                (keys[int(rng.integers(0, len(keys)))],
                 None if rng.random() < 0.3
                 else rng.bytes(int(rng.integers(1, 64))))
                for _ in range(int(rng.integers(1, 6)))]))
    return out


def apply(db, seq) -> None:
    for op in seq:
        if op[0] == "set":
            db.set(op[1], op[2])
        elif op[0] == "del":
            db.delete(op[1])
        else:
            db.write_batch(op[1])


def scans(db) -> list:
    return [db_bytes(db), list(db.iterate(b"k/05", b"k/09")),
            list(db.iterate_prefix(b"k/1")), list(db.iterate_prefix(b"\xff")),
            db.get(b"k/007"), db.has(b"k/008")]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_filedb_files_are_byte_equal_and_cross_readable(tmp_path, writer):
    files = {}
    for k, p in PACKAGES.items():
        path = str(tmp_path / f"{k}.db")
        db = p.db.FileDB(path)
        apply(db, ops(11))
        files[k] = (path, scans(db))
        db.close()
    assert open(files["port"][0], "rb").read() == \
        open(files["reference"][0], "rb").read()
    reader = REF if writer == "port" else PORT
    db = reader.db.FileDB(files[writer][0])
    assert scans(db) == files[writer][1] == files["port"][1]
    db.close()


def test_filedb_compaction_rewrites_the_same_bytes(tmp_path):
    """Enough churn over few keys to pass the 1 MiB compaction trigger:
    the compacted logs are byte-equal and replay to the same set."""
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / f"{k}.db")
        db = p.db.FileDB(path)
        rng = np.random.default_rng(3)
        for i in range(700):
            db.set(b"c%d" % (i % 5), rng.bytes(2048))
        size = os.path.getsize(path)
        db.close()
        db = p.db.FileDB(path)
        got.append((size, open(path, "rb").read(), db_bytes(db)))
        db.close()
    assert got[0] == got[1] and got[0][0] < 700 * 2048


def test_filedb_torn_batch_replays_none_of_it(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / f"{k}.db")
        db = p.db.FileDB(path)
        db.set(b"before", b"ok")
        size_before = os.path.getsize(path)
        db.write_batch([(b"x", b"1"), (b"y", b"2"), (b"z", b"3")])
        db.close()
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 1)
        db = p.db.FileDB(path)
        got.append((db_bytes(db), os.path.getsize(path) == size_before,
                    open(path + ".corrupt.000", "rb").read()))
        db.close()
    assert got[0] == got[1] and got[0][0] == {b"before": b"ok"} and got[0][1]


def test_filedb_quarantine_slots_are_capped(tmp_path):
    """Ten torn restarts: the first eight tails keep slots 000-007, the
    newest slot is reused after that."""
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "kv.db")
        os.makedirs(os.path.dirname(path))
        for i in range(10):
            db = p.db.FileDB(path)
            db.set(b"k%d" % i, b"v" * (i + 1))
            db.close()
            with open(path, "ab") as f:
                f.write(b"torn-%d" % i)
        db = p.db.FileDB(path)
        db.close()
        names = sorted(os.listdir(os.path.dirname(path)))
        got.append((names, [open(os.path.join(os.path.dirname(path), n),
                                 "rb").read() for n in names]))
    assert got[0] == got[1] and len(got[0][0]) == 9


def test_filedb_failed_append_keeps_memory_and_disk_agreeing(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        path = str(tmp_path / f"{k}.db")
        db = p.db.FileDB(path)
        db.set(b"a", b"1")
        p.failpoints.arm("db.set", "error")
        try:
            errs = [outcome(lambda: db.set(b"b", b"2")),
                    outcome(lambda: db.write_batch([(b"c", b"3"),
                                                    (b"a", None)])),
                    outcome(lambda: db.delete(b"a"))]
        finally:
            p.failpoints.disarm_all()
        mem = db_bytes(db)
        db.close()
        db = p.db.FileDB(path)
        got.append((errs, mem, db_bytes(db)))
        db.close()
    assert got[0] == got[1] and got[0][1] == got[0][2] == {b"a": b"1"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sqlitedb_rows_equal_and_cross_readable(tmp_path, writer):
    """More rows than one iteration page (512): equal scans, and each
    package reads the other's file."""
    files = {}
    for k, p in PACKAGES.items():
        path = str(tmp_path / k / "kv.sqlite")
        db = p.db.SqliteDB(path)
        apply(db, ops(12, 300))
        db.write_batch([(b"page/%05d" % i, b"%d" % i) for i in range(1300)])
        files[k] = (path, scans(db), list(db.iterate_prefix(b"page/")))
        db.close()
    assert files["port"][1:] == files["reference"][1:]
    reader = REF if writer == "port" else PORT
    db = reader.db.SqliteDB(files[writer][0])
    assert (scans(db), list(db.iterate_prefix(b"page/"))) == \
        tuple(files[writer][1:])
    db.close()


def test_sqlitedb_synchronous_and_failpoint(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        modes = []
        for mode in ("FULL", "normal", "OFF"):
            db = p.db.SqliteDB(str(tmp_path / k / f"kv-{mode}.sqlite"),
                               synchronous=mode)
            db.set(b"k", b"v")
            modes.append(db._c.execute("PRAGMA synchronous").fetchone()[0])
            db.close()
        bad = outcome(lambda: p.db.SqliteDB(str(tmp_path / k / "bad.sqlite"),
                                            synchronous="EXTRA"))
        db = p.db.SqliteDB(str(tmp_path / k / "fp.sqlite"))
        db.set(b"a", b"1")
        p.failpoints.arm("db.set", "error")
        try:
            errs = [outcome(lambda: db.set(b"b", b"2")),
                    outcome(lambda: db.write_batch([(b"c", b"3")]))]
        finally:
            p.failpoints.disarm_all()
        rows = db_bytes(db)
        db.write_batch([(b"c", b"3"), (b"a", None)])  # no open transaction left
        got.append((modes, bad, errs, rows, db_bytes(db)))
        db.close()
    assert got[0] == got[1]
    assert got[0][1][0] == "ValueError" and got[0][3] == {b"a": b"1"}


@pytest.mark.parametrize("field,value", [
    ("db_backend", "leveldb"), ("db_synchronous", "sometimes"),
    ("db_synchronous", "normal"), ("db_backend", "filedb")])
def test_base_config_validation_equals_reference(field, value):
    got = []
    for p in (PORT, REF):
        cfg = p.config.BaseConfig(**{field: value})
        got.append((outcome(cfg.validate_basic), cfg.db_backend,
                    cfg.db_synchronous))
    assert got[0] == got[1]
