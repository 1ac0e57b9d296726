"""Port parity for crash recovery: consensus/replay.py (Handshaker,
_MockReplayClient, _reconcile_wal, _scan_quarantine,
reconcile_and_handshake, handshake_and_load_state, RecoveryReport,
REPAIR_KINDS) over FileDB stores, against the JAX package, in the shapes
of tests/test_recovery.py.

For every commit-pipeline crash point of tests/test_recovery.py's
SKEW_CASES, each package grows the same 4-validator chain over FileDBs
in a directory of its own, stops the real pipeline at that point at
height 3 (an armed `error` failpoint, or between the explicit steps),
reopens every store from disk and runs reconcile_and_handshake: the
recovered height, the repair kinds, the app hash (also against a clean
MemDB run of the same package) and the healed stores' bytes must equal
the reference's, and the healed chain commits one more height to the
clean run's app hash. Host path throughout. Tolerance: exact."""

import asyncio
import os
import shutil

import pytest

from test_torch_execution import PACKAGES, PORT, REF, Node, aoutcome, db_bytes

SKEW_CASES = {
    "store.save_block": ([], -1),
    "consensus.commit.block_saved": (["state_reapply"], 0),
    "state.apply.block_executed": (["state_reapply"], 0),
    "state.apply.responses_saved": (["state_reapply"], 0),
    "state.apply.app_committed": (["state_from_responses"], 0),
    "state.apply.state_saved": ([], 0),
}
CRASH_H = 3


def open_dbs(p, d):
    os.makedirs(d, exist_ok=True)
    return tuple(p.db.FileDB(os.path.join(d, f"{n}.db"))
                 for n in ("state", "blocks", "app"))


def close(dbs):
    for db in dbs:
        db.close()


async def grow(p, dbs, heights: int, crash_at=None) -> dict:
    """Commit `heights` heights through save_block -> apply_block; on
    the last one stop at `crash_at`. The app hash by height."""
    node = await Node(p, dbs=dbs).start()
    hashes = {}
    try:
        for i in range(heights):
            last = i == heights - 1
            h = node.state.last_block_height + 1
            block, bid = node.next_block([b"h%d=x" % h])
            seen = node.seen_commit(block, bid)
            parts = block.make_part_set()
            if last and crash_at == "store.save_block":
                p.failpoints.arm(crash_at, "error")
                got = await aoutcome(_async(node.bs.save_block, block, parts,
                                            seen))
                assert got[0] == "FailpointError"
                break
            node.bs.save_block(block, parts, seen)
            if last and crash_at == "consensus.commit.block_saved":
                break
            if last and crash_at is not None:
                p.failpoints.arm(crash_at, "error")
                got = await aoutcome(node.executor.apply_block(node.state, bid,
                                                               block))
                assert got == ("FailpointError",
                               f"injected failpoint {crash_at!r}")
                break
            node.state, _ = await node.executor.apply_block(node.state, bid,
                                                            block)
            node.last_commit = seen
            hashes[h] = node.state.app_hash
    finally:
        p.failpoints.disarm_all()
        await node.stop()
    return hashes


async def _async(fn, *args):
    return fn(*args)


def oracle(p) -> dict:
    dbs = (p.db.MemDB(), p.db.MemDB(), p.db.MemDB())
    return asyncio.run(grow(p, dbs, CRASH_H + 1))


@pytest.mark.parametrize("point", sorted(SKEW_CASES))
def test_reconciler_heals_each_crash_point_as_the_reference(tmp_path, point):
    want_repairs, rel = SKEW_CASES[point]

    async def go(p, d, clean):
        dbs = open_dbs(p, d)
        await grow(p, dbs, CRASH_H, crash_at=point)
        close(dbs)
        dbs = open_dbs(p, d)  # crash-restart: everything from disk
        try:
            node = await Node(p, dbs=dbs).start()
            rep = node.report
            healed = (node.state.last_block_height,
                      [r["kind"] for r in rep.repairs], rep.blocks_replayed,
                      node.bs.height, node.state.app_hash,
                      node.state.app_hash == node.app.app_hash,
                      db_bytes(dbs[0]), db_bytes(dbs[1]))
            await node.step([b"h%d=x" % (node.state.last_block_height + 1)])
            after = (node.state.last_block_height, node.state.app_hash,
                     db_bytes(dbs[0]), db_bytes(dbs[2]))
            await node.stop()
        finally:
            close(dbs)
        assert healed[4] == clean.get(healed[0], healed[4]) and healed[5]
        assert after[1] == clean[after[0]]
        return healed, after

    got = {k: asyncio.run(go(p, str(tmp_path / k), oracle(p)))
           for k, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    healed, after = got["port"]
    assert healed[0] == CRASH_H + rel and healed[1] == want_repairs
    assert after[0] == CRASH_H + rel + 1


def test_torn_wal_tail_and_reapply_equal_reference(tmp_path):
    """A torn WAL head tail is quarantined and reported before the
    handshake's state_reapply; the WAL's end height, the quarantine
    inventory and the port's recovery family follow."""
    async def go(p, d):
        wal_path = os.path.join(d, "wal", "wal")
        w = p.wal.WAL(wal_path)
        w.write_sync(p.wal.EndHeightMessage(1))
        w.write_sync(p.wal.EndHeightMessage(2))
        w.close()
        with open(wal_path, "ab") as f:
            f.write(b"\xde\xad\xbe\xef-torn-tail")
        dbs = open_dbs(p, d)
        await grow(p, dbs, 2, crash_at="consensus.commit.block_saved")
        close(dbs)
        dbs = open_dbs(p, d)
        node = Node(p, dbs=dbs)
        node.conns = p.proxy.AppConns(p.client.ClientCreator(app=node.app))
        await node.conns.start()
        try:
            state, rep = await p.replay.reconcile_and_handshake(
                None, node.ss, node.bs, node.gdoc, node.conns,
                wal_path=wal_path, scan_dirs=[os.path.dirname(wal_path)])
        finally:
            await node.conns.stop()
            close(dbs)
        d = rep.to_dict()
        d["quarantined_files"] = [os.path.basename(f)
                                  for f in d["quarantined_files"]]
        for r in d["repairs"]:  # the details name the package's directory
            r["detail"] = r["detail"].replace(wal_path, "<wal>")
        return (d, state.last_block_height, state.app_hash,
                [m.msg.height for m in p.wal.WAL.decode_all(wal_path)])

    from tendermint_tpu_torch.libs.metrics import recovery_metrics

    met = recovery_metrics()
    before = ({k: met.repairs.value(kind=k)
               for k in ("wal_torn_tail", "state_reapply")},
              met.blocks_replayed.value())
    got = {k: asyncio.run(go(p, str(tmp_path / k)))
           for k, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    d, height, _, heights = got["port"]
    assert [r["kind"] for r in d["repairs"]] == ["wal_torn_tail",
                                                 "state_reapply"]
    assert d["wal_end_height"] == 2 and d["wal_tail_repaired_bytes"] > 0
    assert d["quarantined_files"] == ["wal.corrupt.000"]
    assert height == 2 and heights == [1, 2]
    for kind in ("wal_torn_tail", "state_reapply"):
        assert met.repairs.value(kind=kind) == before[0][kind] + 1
    assert met.blocks_replayed.value() == before[1] + 1
    assert met.quarantined_files.value() == 1


def test_wal_end_height_survives_rotation(tmp_path):
    got = []
    for k, p in PACKAGES.items():
        wal_path = str(tmp_path / k / "wal")
        w = p.wal.WAL(wal_path)
        w.write_sync(p.wal.EndHeightMessage(1))
        w.write_sync(p.wal.EndHeightMessage(2))
        w._rotate()  # head now empty; the markers live in wal.000
        w.close()
        report = p.replay.RecoveryReport()
        p.replay._reconcile_wal(wal_path, report)
        got.append((report.wal_end_height, report.repairs))
    assert got[0] == got[1] == (2, [])


def test_app_replay_into_an_app_that_lost_its_state(tmp_path):
    """The app's db is gone (app at height 0) while the stores are at
    3: the stored blocks are re-executed into the app, exec-only."""
    async def go(p, d):
        dbs = open_dbs(p, d)
        await grow(p, dbs, CRASH_H)
        close(dbs)
        os.remove(os.path.join(d, "app.db"))
        dbs = open_dbs(p, d)
        try:
            node = await Node(p, dbs=dbs).start()
            out = ([r["kind"] for r in node.report.repairs],
                   node.report.blocks_replayed, node.app.app_hash,
                   node.state.app_hash, db_bytes(dbs[2]))
            await node.stop()
        finally:
            close(dbs)
        return out

    got = {k: asyncio.run(go(p, str(tmp_path / k)))
           for k, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    kinds, blocks, app_hash, state_hash, _ = got["port"]
    assert kinds == ["app_replay"] and blocks == CRASH_H
    assert app_hash == state_hash


def test_app_ahead_of_the_block_store_is_refused(tmp_path):
    async def go(p, d):
        long_dbs = open_dbs(p, os.path.join(d, "long"))
        await grow(p, long_dbs, CRASH_H)
        close(long_dbs)
        short_dbs = open_dbs(p, os.path.join(d, "short"))
        await grow(p, short_dbs, CRASH_H - 1)
        close(short_dbs)
        shutil.copy(os.path.join(d, "long", "app.db"),
                    os.path.join(d, "short", "app.db"))
        dbs = open_dbs(p, os.path.join(d, "short"))
        try:
            node = Node(p, dbs=dbs)
            got = await aoutcome(node.start())
            await node.conns.stop()
        finally:
            close(dbs)
        return got

    got = {k: asyncio.run(go(p, str(tmp_path / k)))
           for k, p in PACKAGES.items()}
    assert got["port"] == got["reference"] == (
        "HandshakeError", f"app height {CRASH_H} ahead of block store "
                          f"{CRASH_H - 1}")


def test_handshake_and_load_state_equals_reference():
    async def go(p):
        node = Node(p)
        node.conns = p.proxy.AppConns(p.client.ClientCreator(app=node.app))
        await node.conns.start()
        state = await p.replay.handshake_and_load_state(
            None, node.ss, node.bs, node.gdoc, node.conns)
        await node.conns.stop()
        return (state.last_block_height, state.app_hash,
                db_bytes(node.dbs[0]), node.app.validators)

    got = [asyncio.run(go(p)) for p in (PORT, REF)]
    assert got[0] == got[1] and len(got[0][3]) == 4  # InitChain's set


def test_mock_replay_client_answers_from_saved_responses():
    async def go(p):
        saved = {
            "begin_block": p.t.ResponseBeginBlock(),
            "deliver_txs": [p.t.ResponseDeliverTx(code=i, data=b"%d" % i)
                            for i in range(3)],
            "end_block": p.t.ResponseEndBlock(),
        }
        c = p.replay._MockReplayClient(saved, b"\x42" * 32)
        out = [await c.deliver(p.t.RequestDeliverTx(b"x")) for _ in range(4)]
        commit = await c.commit()
        empty = p.replay._MockReplayClient(None, b"")
        bad = await aoutcome(c.deliver(p.t.RequestCheckTx(b"x")))
        return ([(r.code, r.data) for r in out], commit.data,
                type(await empty.deliver(p.t.RequestEndBlock(1))).__name__,
                bad)

    got = [asyncio.run(go(p)) for p in (PORT, REF)]
    assert got[0] == got[1]
    assert got[0][3] == ("HandshakeError",
                         "mock replay client got RequestCheckTx")


def test_repair_kinds_are_the_reference_catalog():
    assert PORT.replay.REPAIR_KINDS == REF.replay.REPAIR_KINDS
    rep = PORT.replay.RecoveryReport()
    with pytest.raises(AssertionError):
        rep.record("made_up_kind", "nope")
    for kind in PORT.replay.REPAIR_KINDS:
        rep.record(kind, "exercised", blocks=1)
    assert len(rep.repairs) == len(PORT.replay.REPAIR_KINDS)
    assert rep.blocks_replayed == len(PORT.replay.REPAIR_KINDS)


def test_failpoint_catalog_marks_the_reference_crash_sites():
    ref_crash = {d.name for d in REF.failpoints.CATALOG if d.legacy_index}
    ported = set(PORT.failpoints.CATALOG)
    assert PORT.failpoints.CRASH_SITES == ref_crash & ported
    assert PORT.failpoints.COMMIT_PIPELINE == tuple(
        n for n in REF.failpoints.COMMIT_PIPELINE if n in ported)
    for name in ("wal.torn_write", "wal.fsync", "db.set"):
        assert PORT.failpoints.CATALOG[name] == \
            REF.failpoints.BY_NAME[name].payload
