"""The port's state sync held against the JAX package's (no kernel runs
here: four validators verify on the host). The wire messages byte for
byte; a twin of every test of the reference's tests/test_statesync.py,
each scenario run through both packages' classes and compared (the
pool's ranking, caps and rejections; the scripted syncer's offers,
applies, rejections, quarantines and results; status_check; the
statesync.serve failpoint); the chip phase's script on a small chain
on both packages (a seed, PEX, a poisoner, the top snapshot refused
for its missing h+2, the next restored, the tail fast-synced); state
sync, fast sync and consensus over TCP on the port; a port node
state-syncing from a reference full node; and the port's fault rule: a
KernelError or NoDeviceError under the light check ends sync_any with
it, and one met in the reactor's receive halts the node."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import time
import types

import pytest

from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.device import NoDeviceError

import test_torch_consensus_reactor as harness
from test_torch_consensus_reactor import Node, genesis

_cpu = harness._cpu
DEADLINE_S = 90.0
YEAR_NS = 365 * 24 * 3600 * 10**9

_MODULES = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "client": "abci.client",
    "messages": "statesync.messages", "snapshots": "statesync.snapshots",
    "syncer": "statesync.syncer", "ssreactor": "statesync.reactor",
    "stateprovider": "statesync.stateprovider",
    "failpoints": "libs.failpoints", "db": "libs.db", "light": "light",
    "lerrors": "light.errors", "pex": "p2p.pex", "key": "p2p.key",
    "node_info": "p2p.node_info", "switch": "p2p.switch",
    "transport": "p2p.transport", "bcreactor": "blockchain.reactor",
    "ed25519": "crypto.ed25519", "genesis": "types.genesis",
    "block": "types.block", "mempool": "mempool", "proxy": "proxy",
    "replay": "consensus.replay", "execution": "state.execution",
    "sstore": "state.store", "store": "store", "state": "state",
}


def _namespace(base: types.SimpleNamespace) -> types.SimpleNamespace:
    """The harness's namespace of the package (what Node reads) and
    these modules."""
    ns = types.SimpleNamespace(**vars(base))
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{base.name}.{mod}"))
    return ns


PORT = _namespace(harness.PORT)
REF = _namespace(harness.REF)


def run(coro, deadline: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, deadline))


def metric(p, name: str) -> int:
    """A counter of the statesync family: the port's plain dict, the
    reference's metrics registry."""
    if p is PORT:
        return p.syncer.METRICS[name]
    from tendermint_tpu.libs.metrics import statesync_metrics

    return int(getattr(statesync_metrics(), name).value())


def disarm_all(p) -> None:
    (p.failpoints.disarm_all if p is PORT else p.failpoints.reset)()


# -- messages -----------------------------------------------------------------


MESSAGES = [
    ("SnapshotsRequestMessage", ()),
    ("SnapshotsResponseMessage", (5, 1, 3, b"\x01" * 32, b"meta")),
    ("ChunkRequestMessage", (5, 1, 0)),
    ("ChunkResponseMessage", (5, 1, 2, b"chunk-data", False)),
    ("ChunkResponseMessage", (5, 1, 0, b"", True)),
]


@pytest.mark.parametrize("name,args", MESSAGES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MESSAGES)])
def test_messages_are_the_reference_bytes(name, args):
    port = getattr(PORT.messages, name)(*args)
    ref = getattr(REF.messages, name)(*args)
    raw = REF.messages.encode_ss_msg(ref)
    assert PORT.messages.encode_ss_msg(port) == raw
    assert PORT.messages.decode_ss_msg(raw) == port
    assert REF.messages.decode_ss_msg(PORT.messages.encode_ss_msg(port)) == ref
    assert PORT.messages.MAX_MSG_SIZE == REF.messages.MAX_MSG_SIZE


@pytest.mark.parametrize("p", [PORT, REF], ids=["port", "reference"])
def test_messages_roundtrip_and_refusals(p):
    m = p.messages
    for name, args in MESSAGES:
        msg = getattr(m, name)(*args)
        assert m.decode_ss_msg(m.encode_ss_msg(msg)) == msg
    bad = [m.encode_ss_msg(m.SnapshotsResponseMessage(0, 1, 0, b"")),
           b"", b"\x09", b"\x02" + b"\x00" * (m.MAX_MSG_SIZE + 1)]
    for raw in bad:
        with pytest.raises(ValueError):
            m.decode_ss_msg(raw)


# -- the config ---------------------------------------------------------------


def test_statesync_config_is_the_reference_fields_its_node_reads():
    """The port's StateSyncConfig: the reference's fields with their
    defaults, less the chunk fetchers and their timeout, which the
    syncer takes from its constants in both packages; validate_basic
    refuses what the reference's refuses."""
    import dataclasses

    from tendermint_tpu import config as rconfig
    from tendermint_tpu_torch import config as pconfig

    port, ref = pconfig.StateSyncConfig(), rconfig.StateSyncConfig()
    names = [f.name for f in dataclasses.fields(port)]
    assert names == ["enable", "rpc_servers", "trust_height", "trust_hash",
                     "trust_period_s", "discovery_time_s"]
    assert {n: getattr(port, n) for n in names} == \
        {n: getattr(ref, n) for n in names}
    assert PORT.syncer.CHUNK_FETCHERS == ref.chunk_fetchers
    assert PORT.syncer.CHUNK_TIMEOUT == ref.chunk_request_timeout_s
    for kw in (dict(enable=True), dict(enable=True, trust_height=-1)):
        with pytest.raises(ValueError, match="trust_height"):
            pconfig.StateSyncConfig(**kw).validate_basic()
        with pytest.raises(ValueError, match="trust_height"):
            rconfig.StateSyncConfig(**kw).validate_basic()
    pconfig.StateSyncConfig(enable=True, trust_height=1).validate_basic()
    pconfig.StateSyncConfig().validate_basic()


# -- the pool -----------------------------------------------------------------


def _snap(p, h, fmt=1, chunks=1, hash_=None):
    return p.snapshots.Snapshot(h, fmt, chunks, hash_ or bytes([h]) * 32)


def pool_ranking(p):
    pool = p.snapshots.SnapshotPool()
    out = [pool.add("p1", _snap(p, 5)), pool.add("p2", _snap(p, 5)),
           pool.add("p1", _snap(p, 8)), pool.best().height]
    pool.reject(_snap(p, 8))
    out += [pool.best().height, pool.add("p3", _snap(p, 8)),
            pool.peers_of(_snap(p, 5))]
    pool.remove_peer("p1")
    pool.remove_peer("p2")
    out.append(pool.best())
    pool.reject_format(1)
    out.append(pool.add("p4", _snap(p, 9)))
    assert out == [True, False, True, 8, 5, False, ["p1", "p2"], None,
                   False]
    return out


def pool_per_peer_cap(p):
    struck = []
    pool = p.snapshots.SnapshotPool(per_peer_cap=3,
                                    on_peer_overflow=struck.append)
    out = [pool.add("flooder", _snap(p, h)) for h in range(1, 4)]
    out += [list(struck), pool.add("flooder", _snap(p, 4)), list(struck),
            len(pool), pool.add("honest", _snap(p, 4)),
            pool.add("flooder", _snap(p, 3)), list(struck)]
    assert out == [True, True, True, [], False, ["flooder"], 3, True,
                   False, ["flooder"]]
    return out


def pool_global_cap(p):
    pool = p.snapshots.SnapshotPool(global_cap=3)
    out = [pool.add("p1", _snap(p, h)) for h in (5, 6, 7)]
    out += [pool.add("p1", _snap(p, 8)), len(pool),
            sorted(s.height for s in pool._snapshots.values()),
            pool.add("p1", _snap(p, 2)),
            sorted(s.height for s in pool._snapshots.values())]
    assert out[3:] == [True, 3, [6, 7, 8], False, [6, 7, 8]]
    return out


def pool_missing_and_peers(p):
    pool = p.snapshots.SnapshotPool()
    s = _snap(p, 6, chunks=2)
    for peer in ("b", "a", "c"):
        pool.add(peer, s)
    out = [pool.peers_of(s)]
    pool.remove_peer_snapshot("a", s)
    pool.reject_peer("b")
    out += [pool.peers_of(s), pool.is_rejected_peer("b"),
            pool.rejected_peers(), pool.add("b", _snap(p, 9))]
    pool.remove_peer_snapshot("c", s)
    out += [pool.best(), len(pool)]
    return out


@pytest.mark.parametrize("scenario", [pool_ranking, pool_per_peer_cap,
                                      pool_global_cap, pool_missing_and_peers],
                         ids=lambda f: f.__name__)
def test_pool_agrees_with_the_reference(scenario):
    assert scenario(PORT) == scenario(REF)


# -- the syncer against a scripted app ------------------------------------------


class ScriptedApp:
    """A snapshot connection with set verdicts; records every call."""

    def __init__(self, p, chunks, app_hash=b"\x0a" * 8, offer=None):
        self.p, self.chunks, self.final_app_hash = p, chunks, app_hash
        self.offer_result = offer if offer is not None else \
            p.abci.OfferSnapshotResult.ACCEPT
        self.calls: list = []
        self.applied: list = []

    async def offer_snapshot(self, req):
        self.calls.append(("offer", req.snapshot.height, req.snapshot.format))
        return self.p.abci.ResponseOfferSnapshot(self.offer_result)

    async def apply_snapshot_chunk(self, req):
        self.calls.append(("apply", req.index, req.sender))
        self.applied.append(req.index)
        return self.p.abci.ResponseApplySnapshotChunk(
            self.p.abci.ApplySnapshotChunkResult.ACCEPT)

    async def info(self, req):
        self.calls.append(("info",))
        return self.p.abci.ResponseInfo(
            last_block_height=6, last_block_app_hash=self.final_app_hash)


class FakeStateProvider:
    def __init__(self, app_hash=b"\x0a" * 8, fail=None):
        self._hash, self.fail, self.asked = app_hash, fail or {}, []

    async def app_hash(self, height):
        self.asked.append(height)
        if height in self.fail:
            raise self.fail[height]
        return self._hash

    async def state(self, height):
        return f"state@{height}"

    async def commit(self, height):
        return f"commit@{height}"


class AsyncConn:
    """An async snapshot connection over a (sync) kvstore app."""

    def __init__(self, app):
        self._app = app
        self.calls: list = []

    async def offer_snapshot(self, req):
        self.calls.append(("offer", req.snapshot.height))
        return self._app.offer_snapshot(req)

    async def apply_snapshot_chunk(self, req):
        self.calls.append(("apply", req.index, req.sender))
        return self._app.apply_snapshot_chunk(req)

    async def info(self, req):
        return self._app.info(req)

    async def list_snapshots(self, req=None):
        return self._app.list_snapshots(req)

    async def load_snapshot_chunk(self, req):
        return self._app.load_snapshot_chunk(req)


def feeder(p, sy, serve):
    """request_chunk: `serve(peer_id, snapshot, idx)` gives (chunk,
    missing) or None (no answer), delivered at once."""
    async def request(peer_id, snapshot, idx):
        got = serve(peer_id, snapshot, idx)
        if got is not None:
            sy.add_chunk(p.messages.ChunkResponseMessage(
                snapshot.height, snapshot.format, idx, got[0],
                missing=got[1]), peer_id)
    return request


async def sync_trace(p, sy, app) -> dict:
    """Run sync_any; the result or the error, and the syncer's record."""
    q0 = metric(p, "peers_quarantined")
    r0 = metric(p, "restore_attempts")
    try:
        res = await asyncio.wait_for(sy.sync_any(), 30)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        res = type(e).__name__
    return dict(result=res, calls=getattr(app, "calls", None),
                quarantined=sy.quarantined_peers(),
                rejected=sorted(k[:2] for k in sy.pool._rejected_snapshots),
                attempt=sy._restore_attempt,
                quarantines=metric(p, "peers_quarantined") - q0,
                attempts=metric(p, "restore_attempts") - r0)


def syncer_happy_path(p):
    chunks = [b"c0", b"c1", b"c2"]
    app = ScriptedApp(p, chunks)
    sy = p.syncer.Syncer(app, FakeStateProvider(), request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (chunks[i], False))
    sy.add_snapshot("p1", _snap(p, 6, chunks=3))
    out = run(sync_trace(p, sy, app))
    assert out["result"] == ("state@6", "commit@6")
    assert app.applied == [0, 1, 2]
    return out


def syncer_missing_chunk_falls_back(p):
    chunks = [b"c0", b"c1"]
    app = ScriptedApp(p, chunks)
    sy = p.syncer.Syncer(app, FakeStateProvider(), request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda peer, s, i: (
        (b"", True) if peer == "p1" else (chunks[i], False)))
    snap = _snap(p, 6, chunks=2)
    sy.add_snapshot("p1", snap)
    sy.add_snapshot("p2", snap)
    out = run(sync_trace(p, sy, app))
    assert out["result"][0] == "state@6"
    assert sy.pool.peers_of(snap) == ["p2"]
    return out


def syncer_all_peers_missing_rejects(p):
    chunks = [b"c0"]
    app = ScriptedApp(p, chunks)
    sy = p.syncer.Syncer(app, FakeStateProvider(), request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (
        (b"", True) if s.height == 8 else (chunks[i], False)))
    sy.add_snapshot("p1", _snap(p, 8, chunks=1))
    sy.add_snapshot("p1", _snap(p, 6, chunks=1))
    out = run(sync_trace(p, sy, app))
    assert out["result"][0] == "state@6"
    return out


def syncer_bad_app_hash_then_fails(p):
    chunks = [b"c0"]
    app = ScriptedApp(p, chunks, app_hash=b"\xbb" * 8)
    sy = p.syncer.Syncer(app, FakeStateProvider(app_hash=b"\x0a" * 8),
                         request_chunk=None, discovery_time=0.3)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (chunks[i], False))
    sy.add_snapshot("p1", _snap(p, 6, chunks=1))
    out = run(sync_trace(p, sy, app))
    assert out["result"] == "StateSyncError"
    assert out["quarantined"] == ["p1"] and out["attempt"] == 2
    return out


def syncer_format_rejection(p):
    A = p.abci

    class PickyApp(ScriptedApp):
        async def offer_snapshot(self, req):
            await super().offer_snapshot(req)
            return A.ResponseOfferSnapshot(
                A.OfferSnapshotResult.REJECT_FORMAT
                if req.snapshot.format == 1 else
                A.OfferSnapshotResult.ACCEPT)

    chunks = [b"c0"]
    app = PickyApp(p, chunks)
    sy = p.syncer.Syncer(app, FakeStateProvider(), request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (chunks[i], False))
    sy.add_snapshot("p1", p.snapshots.Snapshot(6, 2, 1, b"\x01" * 32))
    sy.add_snapshot("p1", p.snapshots.Snapshot(6, 1, 1, b"\x02" * 32))
    out = run(sync_trace(p, sy, app))
    assert out["result"][0] == "state@6"
    offers = [c for c in app.calls if c[0] == "offer"]
    assert offers[0][2] == 1 and offers[-1][2] == 2
    return out


def syncer_light_client_error_tries_next(p):
    """The state provider cannot verify the best snapshot (a
    LightClientError, e.g. no block at h+2): it is rejected, the next
    one restores."""
    chunks = [b"c0"]
    app = ScriptedApp(p, chunks)
    prov = FakeStateProvider(fail={8: p.lerrors.LightClientError("no h+2")})
    sy = p.syncer.Syncer(app, prov, request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (chunks[i], False))
    sy.add_snapshot("p1", _snap(p, 8, chunks=1))
    sy.add_snapshot("p1", _snap(p, 6, chunks=1))
    out = run(sync_trace(p, sy, app))
    assert out["result"][0] == "state@6" and out["rejected"] == [(8, 1)]
    assert prov.asked == [8, 6]
    return out


def server_app_with_snapshot(p, min_chunks=3):
    """A PersistentKVStoreApp grown until its interval snapshot spans at
    least min_chunks chunks, and the snapshot."""
    server = p.kvstore.PersistentKVStoreApp(snapshot_interval=6)
    for h in range(1, 7):
        for i in range(4):
            server.deliver_tx(p.abci.RequestDeliverTx(
                b"k%d-%d=" % (h, i) + b"v" * 4000))
        server.commit(p.abci.RequestCommit())
    s = server.list_snapshots(p.abci.RequestListSnapshots()).snapshots[-1]
    assert s.chunks >= min_chunks, s.chunks
    return server, p.snapshots.Snapshot(s.height, s.format, s.chunks, s.hash)


def poisoned_run(p, poisoner: str, holders):
    server, snap = server_app_with_snapshot(p)
    restoring = p.kvstore.PersistentKVStoreApp()
    strikes = []
    conn = AsyncConn(restoring)
    sy = p.syncer.Syncer(conn, FakeStateProvider(app_hash=server.app_hash),
                         request_chunk=None,
                         on_strike=lambda peer, r: strikes.append(peer))

    def serve(peer, s, idx):
        chunk = server.load_snapshot_chunk(p.abci.RequestLoadSnapshotChunk(
            height=s.height, format=s.format, chunk=idx)).chunk
        if peer == poisoner:
            chunk = chunk[:7] + b"\xff" + chunk[8:]
        return chunk, False

    sy.request_chunk = feeder(p, sy, serve)
    for peer in holders:
        sy.add_snapshot(peer, snap)
    out = run(sync_trace(p, sy, conn))
    assert out["result"] == (f"state@{snap.height}", f"commit@{snap.height}")
    assert restoring.app_hash == server.app_hash
    assert restoring.height == server.height
    assert restoring._snapshot_payload() == server._snapshot_payload()
    assert out["quarantined"] == [poisoner] and poisoner in strikes
    assert sy.pool._rejected_snapshots == set()
    assert out["quarantines"] == 1
    return out


def syncer_poisoned_bootstrap_quarantines_by_name(p):
    out = poisoned_run(p, "peer-poison", ("honest-a", "honest-b",
                                          "peer-poison"))
    assert out["attempt"] >= 2
    return out


def syncer_single_source_conviction(p):
    out = poisoned_run(p, "aa-poison", ("aa-poison", "honest-a", "honest-b"))
    assert out["attempt"] == 3 and out["attempts"] == 3
    return out


def syncer_reject_senders_and_refetch(p):
    A = p.abci
    chunks = [b"c0", b"c1", b"c2"]

    class VerdictApp(ScriptedApp):
        async def apply_snapshot_chunk(self, req):
            await super().apply_snapshot_chunk(req)
            if req.index == 0 and self.applied.count(0) == 1:
                return A.ResponseApplySnapshotChunk(
                    A.ApplySnapshotChunkResult.ACCEPT, refetch_chunks=[1],
                    reject_senders=["p-bad"])
            return A.ResponseApplySnapshotChunk(
                A.ApplySnapshotChunkResult.ACCEPT)

    app = VerdictApp(p, chunks)
    sy = p.syncer.Syncer(app, FakeStateProvider(), request_chunk=None)
    served = []

    def serve(peer, s, idx):
        served.append((peer, idx))
        return chunks[idx], False

    sy.request_chunk = feeder(p, sy, serve)
    snap = _snap(p, 6, chunks=3)
    for peer in ("p-bad", "p-good"):
        sy.add_snapshot(peer, snap)
    out = run(sync_trace(p, sy, app))
    assert out["result"][0] == "state@6"
    assert out["quarantined"] == ["p-bad"] and sy.pool.is_rejected_peer("p-bad")
    assert {i for _, i in served[3:]} >= {1, 2}
    assert all(peer == "p-good" for peer, _ in served[3:])
    assert app.applied[-2:] == [1, 2]
    out["served"] = served
    return out


def syncer_status_check(p):
    sy = p.syncer.Syncer(None, FakeStateProvider(), request_chunk=None)
    out = [sy.status_check()]
    sy._active = _snap(p, 9, chunks=4)
    sy._applied_count = 2
    sy._restore_attempt = 2
    sy._quarantine("peer-evil", "test")
    out.append(sy.status_check())
    sy.add_chunk(p.messages.ChunkResponseMessage(9, 1, 3, b"late"),
                 "peer-evil")
    out.append(3 in sy._chunks)
    assert out[0]["status"] == "ok" and out[1]["status"] == "degraded"
    assert out[1]["quarantined_peers"] == ["peer-evil"] and not out[2]
    return out


def syncer_apply_failpoint_retries(p):
    """statesync.apply `corrupt` on one chunk of the first attempt: the
    kvstore refuses the assembled payload, the restore retries from one
    peer and completes."""
    server, snap = server_app_with_snapshot(p)
    restoring = p.kvstore.PersistentKVStoreApp()
    conn = AsyncConn(restoring)
    sy = p.syncer.Syncer(conn, FakeStateProvider(app_hash=server.app_hash),
                         request_chunk=None)
    sy.request_chunk = feeder(p, sy, lambda _, s, i: (
        server.load_snapshot_chunk(p.abci.RequestLoadSnapshotChunk(
            height=s.height, format=s.format, chunk=i)).chunk, False))
    for peer in ("a", "b"):
        sy.add_snapshot(peer, snap)
    disarm_all(p)
    p.failpoints.arm("statesync.apply", "corrupt", nth=2)
    try:
        out = run(sync_trace(p, sy, conn))
    finally:
        disarm_all(p)
    assert out["result"][0] == f"state@{snap.height}"
    assert restoring.app_hash == server.app_hash and out["attempt"] == 2
    return out


SCENARIOS = [syncer_happy_path, syncer_missing_chunk_falls_back,
             syncer_all_peers_missing_rejects, syncer_bad_app_hash_then_fails,
             syncer_format_rejection, syncer_light_client_error_tries_next,
             syncer_poisoned_bootstrap_quarantines_by_name,
             syncer_single_source_conviction,
             syncer_reject_senders_and_refetch, syncer_status_check,
             syncer_apply_failpoint_retries]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_syncer_agrees_with_the_reference(scenario):
    assert scenario(PORT) == scenario(REF)


class _Peer:
    id = "peer-x"

    def __init__(self, p):
        self.p, self.sent = p, []

    async def send(self, chan, msg):
        self.sent.append((chan, self.p.messages.decode_ss_msg(msg)))
        return True


def test_serve_failpoint_corrupts_outbound_chunks_as_the_reference_does():
    def go(p):
        server, snap = server_app_with_snapshot(p, min_chunks=1)
        reactor = p.ssreactor.StateSyncReactor(AsyncConn(server), None)
        peer = _Peer(p)
        true_chunk = server.load_snapshot_chunk(
            p.abci.RequestLoadSnapshotChunk(height=snap.height, format=1,
                                            chunk=0)).chunk

        async def requests():
            for h in (snap.height, 999_999):
                await reactor.receive(
                    p.ssreactor.CHUNK_CHANNEL, peer,
                    p.messages.encode_ss_msg(p.messages.ChunkRequestMessage(
                        height=h, format=1, index=0)))

        disarm_all(p)
        p.failpoints.arm("statesync.serve", "corrupt")
        try:
            run(requests())
        finally:
            disarm_all(p)
        (chan, served), (_, absent) = peer.sent
        assert chan == p.ssreactor.CHUNK_CHANNEL
        assert served.chunk != true_chunk and not served.missing
        assert absent.missing and absent.chunk == b""
        return served.chunk, absent.chunk

    assert go(PORT) == go(REF)


# -- the chip phase's script on a small chain -----------------------------------


CHAIN_VALS, INTERVAL, BLOCKS, TXS, VALUE = 4, 4, 13, 8, 2_048
T0 = 1_700_000_000 * 10**9


def p2p_key(p, kind: bytes, i: int = 0):
    """chip_smoke's key derivation: the same node ids as its phase."""
    return p.ed25519.Ed25519PrivKey(
        hashlib.sha256(b"p2p-%s-%d" % (kind, i)).digest())


class TxFeed:
    def __init__(self, p):
        self.nop, self.txs = p.mempool.NopMempool(), []

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs)

    def __getattr__(self, name):
        return getattr(self.nop, name)


async def build_chain(p):
    """BLOCKS blocks of TXS padded kvstore txs through a BlockExecutor,
    every commit signed by all, the app snapshotting every INTERVAL;
    the app hash and the app's `kv:` items after each height."""
    B = p.block
    keys = [p2p_key(p, b"ss-val", i) for i in range(CHAIN_VALS)]
    gdoc = p.genesis.GenesisDoc(
        chain_id="ss-small", genesis_time=T0,
        validators=[p.genesis.GenesisValidator(k.pub_key(), 10)
                    for k in keys])
    gdoc.validate_and_complete()
    sdb = p.db.MemDB()
    ss, bs = p.sstore.Store(sdb), p.store.BlockStore(p.db.MemDB())
    app = p.kvstore.PersistentKVStoreApp(p.db.MemDB(),
                                         snapshot_interval=INTERVAL)
    conns = p.proxy.AppConns(p.client.ClientCreator(app=app))
    await conns.start()
    state = await p.replay.handshake_and_load_state(None, ss, bs, gdoc,
                                                    conns)
    feed = TxFeed(p)
    ex = p.execution.BlockExecutor(ss, conns.consensus, mempool=feed)
    key_of = {k.pub_key().address(): k for k in keys}
    last, app_hashes, kvs = None, {}, {}
    for h in range(1, BLOCKS + 1):
        feed.txs = [b"ss-%d-%d=" % (h, j) + (b"%d" % (h * j)).ljust(VALUE, b".")
                    for j in range(TXS)]
        block = ex.create_proposal_block(
            h, state, last, state.validators.get_proposer().address)
        parts = block.make_part_set()
        bid = B.BlockID(block.hash(), parts.header())
        ts = block.header.time + 10**9
        vals = state.validators.validators
        commit = B.Commit(h, 0, bid, [
            B.CommitSig(B.BlockIDFlag.COMMIT, v.address, ts, b"")
            for v in vals])
        for i, v in enumerate(vals):
            commit.signatures[i].signature = key_of[v.address].sign(
                commit.vote_sign_bytes(gdoc.chain_id, i))
        bs.save_block(block, parts, commit)
        state, _ = await ex.apply_block(state, bid, block)
        last = commit
        app_hashes[h] = state.app_hash
        kvs[h] = list(app.db.iterate_prefix(b"kv:"))
    return gdoc, bs, ss, state, conns, app_hashes, kvs


class Poisoned:
    """A snapshot connection whose chunks come back with one byte
    flipped."""

    def __init__(self, conn):
        self._conn = conn

    async def load_snapshot_chunk(self, req):
        res = await self._conn.load_snapshot_chunk(req)
        if res.chunk:
            b = bytearray(res.chunk)
            b[len(b) // 2] ^= 0x01
            res = type(res)(bytes(b))
        return res

    def __getattr__(self, name):
        return getattr(self._conn, name)


async def server(p, gdoc, state, store, kind, i, snapshots, book,
                 seed_mode=False):
    nk = p.key.NodeKey(p2p_key(p, kind, i))
    holder = {}

    def ni():
        t = holder["transport"]
        return p.node_info.NodeInfo(
            node_id=nk.id, listen_addr=t.listen_addr if t._server else "",
            network=gdoc.chain_id, moniker=f"{kind.decode()}{i}",
            channels=holder["switch"].channel_ids())

    transport = p.transport.Transport(nk, ni)
    holder["transport"] = transport
    sw = holder["switch"] = p.switch.Switch(transport, ni)
    sw.add_reactor("blockchain", p.bcreactor.BlockchainReactor(
        state, None, store, fast_sync=False))
    sw.add_reactor("statesync", p.ssreactor.StateSyncReactor(snapshots))
    book.add_our_address(nk.id)
    sw.add_reactor("pex", p.pex.PEXReactor(book, seed_mode=seed_mode))
    await transport.listen("127.0.0.1", 0)
    await sw.start()
    return sw, f"{nk.id}@{transport.listen_addr}"


async def until(cond, what: str):
    for _ in range(3000):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(what)


def light_provider(p, gdoc, bs, ss, now_ns, node):
    L = p.light
    prov = L.BlockStoreProvider(bs, ss, name="primary")
    lc = L.Client(gdoc.chain_id,
                  L.TrustOptions(period_ns=10 * YEAR_NS, height=1,
                                 hash=bs.load_block_meta(1).block_id.hash),
                  prov, [L.BlockStoreProvider(bs, ss, name="witness")],
                  L.LightStore(p.db.MemDB()), now_fn=lambda: now_ns)
    return p.stateprovider.LightClientStateProvider(
        lc, consensus_params=node.cs.state.consensus_params)


async def chip_script(p) -> dict:
    """chip_smoke's statesync phase at 4 validators: two honest servers
    and a poisoner (its id sorts first) serve the chain and its
    snapshots, a seed knows them; a fresh node given only the seed
    finds them by PEX, state-syncs, fast-syncs the tail and hands over
    to consensus."""
    gdoc, bs, ss, state, conns, app_hashes, kvs = await build_chain(p)
    empty = p.proxy.AppConns(p.client.ClientCreator(
        app=p.kvstore.PersistentKVStoreApp(p.db.MemDB())))
    await empty.start()
    books = [p.pex.AddrBook() for _ in range(4)]
    snap_conn = conns.snapshot
    servers = [await server(p, gdoc, state, bs, b"ss-server", i, snap_conn,
                            books[i]) for i in range(2)]
    servers.append(await server(p, gdoc, state, bs, b"ss-poisoner", 56,
                                Poisoned(snap_conn), books[2]))
    seed = await server(p, gdoc, state, p.store.BlockStore(p.db.MemDB()),
                        b"ss-seed", 0, empty.snapshot, books[3],
                        seed_mode=True)
    for book in books:
        for _, a in servers:
            book.add_address(a)
    hung_up = []
    remove = seed[0]._remove_peer

    async def recorded(peer, reason):
        hung_up.append((peer.id, str(reason)))
        return await remove(peer, reason)

    seed[0]._remove_peer = recorded
    ids = {a.split("@")[0] for _, a in servers}
    poisoner = servers[-1][1].split("@")[0]
    assert poisoner < min(ids - {poisoner})
    now = bs.load_block(BLOCKS).header.time + 3600 * 10**9
    node = Node(p, gdoc, None, "ss-joiner", seeds=[seed[1]],
                ensure_period=0.2,
                state_provider_factory=lambda n: light_provider(
                    p, gdoc, bs, ss, now, n))
    await node.start(wait_sync=True)
    try:
        sy = node.ss_reactor.syncer
        await until(lambda: ids <= set(node.switch.peers), "PEX discovery")
        await until(lambda: len(sy.pool) == 3 and all(
            set(sy.pool.peers_of(s)) == ids
            for s in sy.pool._snapshots.values()), "every snapshot")
        state_, commit = await node.ss_reactor.sync()
        h = state_.last_block_height
        # the kvstore's app hash is only its key count: the restored
        # `kv:` items, keys and values, against the chain app's at h
        restored = (node.app.height, node.app.app_hash == app_hashes[h],
                    list(node.app.db.iterate_prefix(b"kv:")) == kvs[h])
        node.state_store.bootstrap(state_)
        node.block_store.save_seen_commit(h, commit)
        await node.bc_reactor.switch_to_fast_sync(state_)
        await asyncio.wait_for(node.bc_reactor.synced.wait(), 60)
        await until(lambda: node.cs.is_running, "the handover")
        top = node.block_store.height
        assert top in (BLOCKS - 1, BLOCKS - 2)
        st = node.bc_reactor.state
        assert [node.block_store.load_block(x).hash()
                for x in range(h + 1, top + 1)] == \
            [bs.load_block(x).hash() for x in range(h + 1, top + 1)]
        assert st.app_hash == app_hashes[top]
        return dict(
            book=ids <= {ka.node_id for ka in node.book._addrs.values()},
            outbound=all(node.switch.peers[i].outbound for i in ids),
            seed_hung_up=(node.node_key.id, "graceful stop") in hung_up,
            rejected=sorted(k[0] for k in sy.pool._rejected_snapshots),
            height=h, restored=restored, quarantined=sy.quarantined_peers(),
            attempt=sy._restore_attempt, base=node.block_store.base)
    finally:
        await node.stop()
        for sw, _ in servers + [seed]:
            await sw.stop()
        await conns.stop()
        await empty.stop()


def test_the_chip_phase_script_on_a_small_chain_agrees():
    port = run(chip_script(PORT))
    ref = run(chip_script(REF))
    assert port == ref
    assert port["rejected"] == [BLOCKS - 1] and port["height"] == BLOCKS - 5
    assert port["restored"] == (BLOCKS - 5, True, True) and \
        port["attempt"] == 3
    assert port["quarantined"] == [
        PORT.key.NodeKey(p2p_key(PORT, b"ss-poisoner", 56)).id]
    assert port["book"] and port["outbound"] and port["seed_hung_up"]
    assert port["base"] == BLOCKS - 4


# -- over TCP: state sync, fast sync, consensus ---------------------------------


def node_light_provider(p, full):
    """A state provider factory: a light client over `full`'s stores,
    read through package `p`'s stores (for a full node of the other
    package, over its DBs: both packages write the same bytes)."""
    def factory(node):
        bs = p.store.BlockStore(full.block_store.db)
        ss = p.sstore.Store(full.state_store.db)
        return light_provider(p, full.gdoc, bs, ss,
                              time.time_ns() + 3600 * 10**9, node)
    return factory


async def sync_from(p, full) -> tuple:
    """A fresh node of package `p` state-syncs from `full` (a validator
    committing with snapshots every 2 heights), bootstraps, fast-syncs
    and follows consensus two heights; the blocks it holds against the
    full node's."""
    b = Node(p, full.gdoc, None, f"ss-{p.name[-5:]}",
             state_provider_factory=node_light_provider(p, full))
    await b.start(wait_sync=True)
    try:
        await b.dial(full)
        state, commit = await asyncio.wait_for(b.ss_reactor.sync(), 30)
        h = state.last_block_height
        assert h >= 2 and h % 2 == 0
        assert b.app.height == h and b.app.app_hash == state.app_hash
        b.state_store.bootstrap(state)
        b.block_store.save_seen_commit(h, commit)
        await b.bc_reactor.switch_to_fast_sync(state)
        await asyncio.wait_for(b.bc_reactor.synced.wait(), 30)
        await b.cs.wait_for_height(full.cs.rs.height + 2, timeout=60)
        top = min(b.block_store.height, full.block_store.height)
        return [b.block_store.load_block(x).hash().hex()
                for x in range(h + 1, top + 1)], \
            [full.block_store.load_block(x).hash().hex()
             for x in range(h + 1, top + 1)]
    finally:
        await b.stop()


def full_node(p):
    gdoc, pvs = genesis(p, 1)
    return Node(p, gdoc, pvs[0], "ss-full", snapshot_interval=2,
                keep_snapshots=10_000, statesync=True)


def test_statesync_then_fastsync_then_consensus():
    async def go():
        a = await full_node(PORT).start()
        try:
            await a.cs.wait_for_height(8, timeout=60)
            return await sync_from(PORT, a)
        finally:
            await a.stop()

    got, want = run(go())
    assert got == want and len(got) >= 2


def test_a_port_node_state_syncs_from_a_reference_full_node():
    async def go():
        a = await full_node(REF).start()
        try:
            await a.cs.wait_for_height(8, timeout=60)
            return await sync_from(PORT, a)
        finally:
            await a.stop()

    got, want = run(go())
    assert got == want and len(got) >= 2


# -- the port's fault rule -------------------------------------------------------


@pytest.mark.parametrize("exc", [KernelError("injected (CUDA code 700)"),
                                 NoDeviceError("injected")],
                         ids=["KernelError", "NoDeviceError"])
def test_a_port_fault_under_the_light_check_ends_sync_any(exc):
    """The port's own fault under the state provider's light check ends
    sync_any with it: no snapshot is rejected and no other is tried or
    offered. (A LightClientError there rejects the snapshot and the next
    restores, as in the reference: syncer_light_client_error_tries_next.)"""
    chunks = [b"c0"]
    app = ScriptedApp(PORT, chunks)
    prov = FakeStateProvider(fail={8: exc})
    sy = PORT.syncer.Syncer(app, prov, request_chunk=None)
    sy.request_chunk = feeder(PORT, sy, lambda _, s, i: (chunks[i], False))
    sy.add_snapshot("p1", _snap(PORT, 8, chunks=1))
    sy.add_snapshot("p1", _snap(PORT, 6, chunks=1))
    with pytest.raises(type(exc)):
        run(sy.sync_any())
    assert prov.asked == [8] and app.calls == []
    assert sy.pool._rejected_snapshots == set() and len(sy.pool) == 2


def test_a_kernel_error_in_the_reactor_receive_halts_the_node(monkeypatch):
    """A KernelError met while the statesync reactor takes a peer's
    snapshot advertisement halts the port node (the switch stops,
    wait_halted re-raises it); the reference stops the peer and runs
    on."""
    async def go(p, exc):
        server, _ = server_app_with_snapshot(p, min_chunks=1)
        gdoc, _ = genesis(p, 1)
        full = Node(p, gdoc, None, "ss-server", statesync=True)
        await full.start()
        full.ss_reactor.app = AsyncConn(server)

        def boom(self, peer_id, snapshot):
            raise exc

        monkeypatch.setattr(p.syncer.Syncer, "add_snapshot", boom)
        b = Node(p, gdoc, None, "ss-victim",
                 state_provider_factory=lambda n: FakeStateProvider())
        await b.start(wait_sync=True)
        try:
            await b.dial(full)
            if p is PORT:
                with pytest.raises(type(exc)):
                    await b.switch.wait_halted(timeout=20)
            else:
                await until(lambda: not b.switch.peers, "the peer stopped")
            return b.switch.is_running, type(b.switch.fault).__name__ \
                if getattr(b.switch, "fault", None) else None
        finally:
            await b.stop()
            await full.stop()

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        (False, "KernelError")
    assert run(go(REF, RuntimeError("injected"))) == (True, None)
