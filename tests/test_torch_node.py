"""The port's node (tendermint_tpu_torch/node) and its RPC routes
(rpc/core.py) held against the JAX package's, on the CPU.

A mixed net of two port Nodes and two reference Nodes (the JAX package's
node/__init__.py Node) runs a merkle-kvstore chain over TCP, each with
its RPC server; at every height the JSON of /block, /commit,
/validators, /block_results, /tx?prove=true and /tx_search from a port
node equals a reference node's, and /abci_query?prove=true does at the
apps' common height. A port RPCProvider over a reference node's RPC
builds the same LightBlocks as the reference's RPCProvider, and the
reverse. Config files save and load across the packages, and
validate_basic refuses the same inputs. The node refuses the surfaces
that are not ported. The port's fault rule on the node's new surfaces:
a KernelError or NoDeviceError from the admission launch under
broadcast_tx_sync answers the request with an error and halts the node;
from state sync it halts the node instead of falling back to fast sync.
No kernel compiles: four validators verify on the host."""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import importlib
import types

import pytest

from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.device import NoDeviceError, set_default_device

CHAIN = "torch-node-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000
DEADLINE_S = 50.0
HEIGHTS = 6

_MODULES = {
    "config": "config", "node": "node", "ed25519": "crypto.ed25519",
    "genesis": "types.genesis", "pv": "types.priv_validator",
    "key": "p2p.key", "jsonrpc": "rpc.jsonrpc", "core": "rpc.core",
    "provider": "light.provider", "merkle": "crypto.merkle",
    "envelope": "types.tx_envelope",
}


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    pbatch.reset_breakers()
    set_default_device(None)


def run(coro):
    return asyncio.run(coro)


def _seed(kind: str, i: int) -> bytes:
    return hashlib.sha256(f"torch-node-{kind}-{i}".encode()).digest()


def genesis(p, n: int):
    gdoc = p.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=GENESIS_TIME,
        validators=[p.genesis.GenesisValidator(
            p.ed25519.Ed25519PrivKey(_seed("val", i)).pub_key(), 10)
            for i in range(n)])
    gdoc.validate_and_complete()
    return gdoc


def config(p, home: str, name: str, **sections):
    """An in-memory node's config: merkle-kvstore, no fast sync, RPC and
    p2p on 127.0.0.1 ports from the OS, a 400 ms commit timeout (a
    height every ~0.5 s, so two nodes' apps are at one height often)."""
    cfg = p.config.Config()
    cfg.base.home = home
    cfg.base.moniker = name
    cfg.base.fast_sync = False
    cfg.base.db_backend = "memdb"
    cfg.base.proxy_app = "merkle-kvstore"
    cfg.consensus = p.config.fast_consensus_config()
    cfg.consensus.timeout_commit_ms = 400
    cfg.consensus.skip_timeout_commit = False
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    for section, values in sections.items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    return cfg


def make_node(p, tmp_path, i: int, n_vals: int, **sections):
    cfg = config(p, str(tmp_path / f"{p.name}-{i}"), f"n{i}", **sections)
    return p.node.Node(
        cfg, priv_validator=p.pv.MockPV(p.ed25519.Ed25519PrivKey(
            _seed("val", i))),
        node_key=p.key.NodeKey(p.ed25519.Ed25519PrivKey(_seed("key", i))),
        genesis_doc=genesis(p, n_vals), in_memory=True)


async def _until(cond, what: str, nodes=()):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + DEADLINE_S
    while not cond():
        for n in nodes:
            if getattr(n.switch, "fault", None) is not None:
                raise n.switch.fault
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


# -- the mixed net ---------------------------------------------------------


async def _same_height(calls):
    """Call each `calls` coroutine factory until every answer names one
    app height (the nodes commit on; their apps prove the latest state)."""
    for _ in range(400):
        got = [await c() for c in calls]
        if len({g["response"]["height"] for g in got}) == 1:
            return got
        await asyncio.sleep(0.01)
    raise AssertionError("the apps never stood at one height")


async def _mixed_net(tmp_path) -> dict:
    kinds = [PORT, REF, PORT, REF]
    nodes = [make_node(p, tmp_path, i, 4) for i, p in enumerate(kinds)]
    for n in nodes:
        await n.start()
    out: dict = {}
    try:
        for i, n in enumerate(nodes):
            later = [m.p2p_addr for m in nodes[i + 1:]]
            if later:
                n.switch.add_persistent_peers(later)
                await n.switch.dial_peers_async(later, persistent=True)
        await _until(lambda: all(n.switch.n_peers() == 3 for n in nodes),
                     "the mesh", nodes)
        http = [k.jsonrpc.HTTPClient("127.0.0.1", n.rpc_port)
                for k, n in zip(kinds, nodes)]
        await _until(lambda: all(n.block_store.height >= 2 for n in nodes),
                     "height 2", nodes)
        # txs over RPC to a port node and to a reference node, one of
        # them a signed envelope
        key = PORT.ed25519.Ed25519PrivKey(_seed("client", 0))
        txs = [b"p%d=v%d" % (i, i) for i in range(3)] + \
            [PORT.envelope.sign_tx(key, b"signed=yes")]
        rtxs = [b"r%d=w%d" % (i, i) for i in range(3)]
        answers = [await http[0].call(
            "broadcast_tx_sync", tx=base64.b64encode(tx).decode())
            for tx in txs]
        answers += [await http[1].call(
            "broadcast_tx_sync", tx=base64.b64encode(tx).decode())
            for tx in rtxs]
        commit = await http[2].call("broadcast_tx_commit",
                                    tx=base64.b64encode(b"c=1").decode())
        out["broadcast"] = answers
        all_txs = txs + rtxs + [b"c=1"]
        hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in all_txs]

        def committed():
            seen = set()
            for h in range(1, nodes[0].block_store.height + 1):
                seen.update(nodes[0].block_store.load_block(h).data.txs)
            return set(all_txs) <= seen

        await _until(committed, "the txs", nodes)
        top = min(n.block_store.height for n in nodes) + 1
        await _until(lambda: all(n.block_store.height >= top + 1
                                 for n in nodes), f"height {top + 1}", nodes)
        out["top"] = top
        out["commit_height"] = int(commit["height"])

        async def routes(cl):
            got = {}
            for h in range(1, top + 1):
                got[("block", h)] = await cl.call("block", height=h)
                got[("commit", h)] = await cl.call("commit", height=h)
                got[("validators", h)] = await cl.call("validators",
                                                       height=h)
                got[("block_results", h)] = await cl.call("block_results",
                                                          height=h)
                got[("tx_search", h)] = await cl.call(
                    "tx_search", query=f"tx.height={h}", per_page=100)
            for hx in hashes:
                got[("tx", hx)] = await cl.call("tx", hash=hx, prove=True)
            return got

        out["routes"] = [await routes(cl) for cl in http]
        queries = {}
        for key_ in (b"p1", b"r2", b"c", b"absent", b"zz"):
            for a, b in ((0, 1), (2, 3)):
                queries[(key_, a, b)] = await _same_height(
                    [lambda cl=http[a], k=key_: cl.call(
                        "abci_query", data=k.hex(), prove=True),
                     lambda cl=http[b], k=key_: cl.call(
                        "abci_query", data=k.hex(), prove=True)])
        out["abci_query"] = queries
        # every route on a port node and on a reference node
        b2 = out["routes"][0][("block", 2)]["block_id"]["hash"]
        every = {}
        for route, params in every_route(b2):
            got = []
            for k in (0, 1):
                try:
                    got.append(await http[k].call(route, **params))
                except (PORT.jsonrpc.RPCError, REF.jsonrpc.RPCError) as e:
                    got.append(("error", e.code, e.message))
            every[route] = got
        out["every_route"] = every
        # the providers: each package's RPCProvider over each package's
        # node
        lbs = {}
        for pk in (PORT, REF):
            for target in (0, 1):
                prov = pk.provider.RPCProvider("127.0.0.1",
                                               nodes[target].rpc_port)
                got = []
                for h in (1, 2, top):
                    lb = await prov.light_block(h)
                    got.append((lb.hash().hex(), lb.validator_set.hash().hex(),
                                pk.core._commit_json(lb.signed_header.commit),
                                pk.core._header_json(lb.signed_header.header),
                                [pk.core._validator_json(v)
                                 for v in lb.validator_set.validators]))
                try:
                    await prov.light_block(top + 100)
                except pk.provider.BlockNotFoundError as e:
                    got.append(("BlockNotFoundError", "not available" in str(e)))
                lbs[(pk.name, target)] = got
        out["providers"] = lbs
        out["faults"] = [getattr(n.switch, "fault", None) for n in nodes]
        return out
    finally:
        for n in nodes:
            await n.stop()


def every_route(block2_hash: str) -> list:
    """(route, params) for each of the 26 routes; the node-local ones
    are compared by shape (their keys), the chain's by value."""
    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    return [
        ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
        ("block", {"height": 2}), ("block_by_hash", {"hash": block2_hash}),
        ("block_results", {"height": 2}),
        ("blockchain", {"min_height": 1, "max_height": 3}),
        ("commit", {"height": 2}), ("validators", {"height": 2}),
        ("consensus_params", {"height": 2}), ("consensus_state", {}),
        ("dump_consensus_state", {}), ("abci_info", {}),
        ("abci_query", {"data": b"p1".hex()}),
        ("broadcast_tx_async", {"tx": b64(b"async=1")}),
        ("broadcast_tx_sync", {"tx": b64(b"p0=v0")}),
        ("broadcast_tx_commit", {"tx": b64(b"p0=v0")}),
        ("unconfirmed_txs", {}), ("num_unconfirmed_txs", {}),
        ("tx", {"hash": "00" * 32}), ("tx_search", {"query": "tx.height=2"}),
        ("block_search", {"query": "block.height = 2"}),
        ("genesis_chunked", {"chunk": 0}),
        ("broadcast_evidence", {"evidence": b64(b"not evidence")}),
        ("check_tx", {"tx": b64(b"chk=1")}),
    ]


NODE_LOCAL = ("health", "status", "net_info", "consensus_state",
              "dump_consensus_state", "abci_info", "abci_query",
              "unconfirmed_txs", "num_unconfirmed_txs", "blockchain")


def shape(x):
    """The keys of a JSON answer, nested; a list by its first item."""
    if isinstance(x, dict):
        return {k: shape(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [shape(x[0])] if x else []
    return type(x).__name__


_NET: dict = {}


def mixed_net(tmp_path_factory) -> dict:
    if not _NET:
        _NET.update(run(_mixed_net(tmp_path_factory.mktemp("mixed"))))
    return _NET


ROUTES = ("block", "commit", "validators", "block_results", "tx_search",
          "tx")


@pytest.mark.parametrize("route", ROUTES)
def test_a_mixed_net_answers_every_route_alike(route, tmp_path_factory):
    net = mixed_net(tmp_path_factory)
    assert net["faults"] == [None] * 4
    got = [{k: v for k, v in r.items() if k[0] == route}
           for r in net["routes"]]
    assert got[0] and got[0] == got[1] == got[2] == got[3]
    if route == "block":
        assert {k[1] for k in got[0]} == set(range(1, net["top"] + 1))
    if route == "commit":
        assert all(v["canonical"] for v in got[0].values())


@pytest.mark.parametrize("route", [r for r, _ in every_route("")])
def test_every_route_answers_like_the_reference(route, tmp_path_factory):
    """Each of the 26 routes on a port node and on a reference node of
    the same net: the chain's answers equal, the node-local ones (its
    id, peers, round state, mempool, the app's latest height) of one
    shape; refusals equal."""
    port, ref = mixed_net(tmp_path_factory)["every_route"][route]
    if route in NODE_LOCAL:
        assert shape(port) == shape(ref)
    else:
        assert port == ref
    if route in ("tx", "broadcast_evidence", "broadcast_tx_sync",
                 "broadcast_tx_commit"):  # absent, garbage, in the cache
        assert port[:2] == ("error", -32603)
    else:
        assert not isinstance(port, tuple)


def test_every_tx_proof_verifies_against_the_blocks_data_hash(
        tmp_path_factory):
    net = mixed_net(tmp_path_factory)
    r = net["routes"][0]
    for (name, hx), res in r.items():
        if name != "tx":
            continue
        block = r[("block", int(res["height"]))]["block"]
        pj = res["proof"]["proof"]
        proof = PORT.merkle.Proof(
            total=pj["total"], index=pj["index"],
            leaf_hash=base64.b64decode(pj["leaf_hash"]),
            aunts=[base64.b64decode(a) for a in pj["aunts"]])
        assert proof.verify(bytes.fromhex(block["header"]["data_hash"]),
                            base64.b64decode(res["tx"]))
    assert [a["code"] for a in net["broadcast"]] == [0] * 7
    assert net["commit_height"] >= 2


def test_abci_query_proofs_equal_the_reference_at_one_height(
        tmp_path_factory):
    net = mixed_net(tmp_path_factory)
    for (key, a, b), (x, y) in net["abci_query"].items():
        assert x == y, (key, a, b)
        assert x["response"]["proof_ops"]["ops"]
    found = {k: x["response"]["log"]
             for (k, _, _), (x, _) in net["abci_query"].items()}
    assert found[b"p1"] == found[b"r2"] == found[b"c"] == "exists"
    assert found[b"absent"] == "does not exist"


@pytest.mark.parametrize("target", [0, 1], ids=["over_port", "over_reference"])
def test_rpc_providers_build_the_reference_light_blocks(target,
                                                        tmp_path_factory):
    net = mixed_net(tmp_path_factory)
    port = net["providers"][("tendermint_tpu_torch", target)]
    ref = net["providers"][("tendermint_tpu", target)]
    assert port == ref
    assert port[-1] == ("BlockNotFoundError", True)


# -- config files ----------------------------------------------------------


def _changed(p):
    cfg = p.config.Config()
    cfg.base.moniker = "changed"
    cfg.base.priv_validator_laddr = "tcp://127.0.0.1:26659"
    cfg.rpc.max_concurrent_requests = 7
    cfg.rpc.rate_limit_rps = 2.5
    cfg.p2p.seeds = "a@127.0.0.1:1,b@127.0.0.1:2"
    cfg.mempool.admission = "strict"
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = ["127.0.0.1:1", "127.0.0.1:2"]
    cfg.statesync.trust_height = 3
    cfg.statesync.trust_hash = "ab" * 32
    cfg.speculation.enabled = False
    cfg.mesh.arena_shards = False
    cfg.crypto.backend = "cpu"
    cfg.tx_index.indexer = "null"
    cfg.chaos.failpoints = "wal.fsync=delay:5;nth=2"
    return cfg


@pytest.mark.parametrize("saver,loader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_reference", "reference_to_port"])
@pytest.mark.parametrize("shape", ["default", "changed"])
def test_config_files_load_across_the_packages(saver, loader, shape,
                                               tmp_path):
    cfg = saver.config.Config() if shape == "default" else _changed(saver)
    path = str(tmp_path / "config" / "config.toml")
    cfg.save(path)
    got = loader.config.Config.load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    got.validate_basic()
    path2 = str(tmp_path / "again" / "config.toml")
    got.save(path2)
    assert open(path2).read() == open(path).read()


REFUSED = [
    ("base", "db_backend", "leveldb"), ("base", "db_synchronous", "ALWAYS"),
    ("rpc", "max_concurrent_requests", -1), ("rpc", "rate_limit_rps", -1.0),
    ("rpc", "timeout_broadcast_tx_commit_ms", -5),
    ("p2p", "pex_ensure_period_s", 0.0), ("mempool", "admission", "maybe"),
    ("statesync", "enable", True), ("fastsync", "version", "v3"),
    ("consensus", "timeout_commit_ms", -1),
    ("speculation", "arena_lanes", 1),
    ("mesh", "expanded_shard_crossover_keys", -1),
    ("crypto", "backend", "gpu"), ("crypto", "ledger_capacity", 8),
    ("tx_index", "indexer", "nulll"), ("light", "pending_max", 1),
    ("chaos", "failpoints", "no.such.point=error"),
    ("chaos", "failpoints", "wal.fsync"),
]


# Values the reference refuses and the port takes (ROADMAP Queue C):
# "gpu" is the port's word for the accelerator promise.
PORT_TAKES = {("crypto", "backend", "gpu")}


@pytest.mark.parametrize("section,field,value", REFUSED,
                         ids=[f"{s}.{f}={v}" for s, f, v in REFUSED])
def test_validate_basic_refuses_what_the_reference_refuses(section, field,
                                                           value):
    for p in (PORT, REF):
        cfg = p.config.Config()
        cfg.validate_basic()
        setattr(getattr(cfg, section), field, value)
        if p is PORT and (section, field, value) in PORT_TAKES:
            cfg.validate_basic()
            continue
        with pytest.raises(ValueError):
            cfg.validate_basic()


@pytest.mark.parametrize("backend", ["gpu", "tpu"])
def test_crypto_backend_gpu_and_its_tpu_alias_promise_the_card(backend):
    """ROADMAP Queue C: the port reads "gpu" and the reference's "tpu"
    as one promise of the accelerator, so a config file loads in either
    package; the watchdog degrades on CPU launches under both."""
    from tendermint_tpu_torch.crypto.cuda import ledger, watchdog

    cfg = PORT.config.Config()
    cfg.crypto.backend = backend
    cfg.validate_basic()
    ledger.reset()
    try:
        watchdog.configure(backend)
        ledger.record(kernel="general", device="cpu", verdict="ok",
                      lanes=8, capacity=128)
        v = watchdog.verdict(budget_bytes=1 << 40)
        assert v["effective_backend"] == "cpu_fallback"
        assert v["status"] == "degraded" and backend in v["reason"]
    finally:
        watchdog.configure("auto")
        ledger.reset()


# -- surfaces that are not ported ----------------------------------------

UNPORTED = [("rpc", "grpc_laddr", "tcp://127.0.0.1:0", "item 9"),
            ("base", "abci", "grpc", "item 9")]


@pytest.mark.parametrize("section,field,value,item", UNPORTED,
                         ids=[f"{s}.{f}" for s, f, _, _ in UNPORTED])
def test_the_node_refuses_what_is_not_ported(section, field, value, item,
                                             tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        make_node(PORT, tmp_path, 0, 1, **{section: {field: value}})


# -- the debug server and the Prometheus listener ------------------------


async def _get(port: int, path: str) -> bytes:
    """One HTTP/1.0 GET on 127.0.0.1; the body."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.0\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data.partition(b"\r\n\r\n")[2]


def _listeners(tmp_path, **sections):
    return make_node(PORT, tmp_path, 0, 1,
                     rpc={"pprof_laddr": "tcp://127.0.0.1:0"},
                     instrumentation={"prometheus": True,
                                      "prometheus_listen_addr":
                                      "127.0.0.1:0"}, **sections)


def test_the_node_serves_metrics_on_both_listeners(tmp_path):
    """instrumentation.prometheus starts a listener whose GET /metrics,
    like the RPC port's, renders the whole catalog under the
    reference's names; consensus_height follows the chain."""
    async def go():
        node = _listeners(tmp_path)
        await node.start()
        try:
            await _until(lambda: node.block_store.height >= 2, "height 2")
            prom = (await _get(node.prometheus_port, "/metrics")).decode()
            rpc = (await _get(node.rpc_port, "/metrics")).decode()
            return prom, rpc
        finally:
            await node.stop()

    prom, rpc = run(go())
    for text in (prom, rpc):
        assert "# TYPE consensus_height gauge" in text
        assert "# TYPE tpu_launch_ledger_records_total counter" in text
        height = next(float(line.split()[1]) for line in text.splitlines()
                      if line.startswith("consensus_height "))
        assert height >= 1
    assert "tracing_span_seconds_bucket" in prom


def test_the_node_serves_its_launches_status_and_trace(tmp_path,
                                                        monkeypatch):
    """rpc.pprof_laddr starts the debug server: an admission flush's K4
    launch (its plain version on the CPU) is one ledger record tagged
    admission and stamped cpu-fallback in /debug/launches; /status
    carries the watchdog's view; /debug/trace is Chrome-trace JSON with
    the node's consensus.height and state.apply_block spans."""
    import json

    from tendermint_tpu_torch.crypto.cuda import ledger

    async def go():
        node = _listeners(tmp_path, mempool={"admission_flush_ms": 0.0})
        await node.start()
        try:
            node.mempool.admission.collector.device_threshold = 1
            ledger.reset()
            cl = PORT.jsonrpc.HTTPClient("127.0.0.1", node.rpc_port)
            tx = PORT.envelope.sign_tx(
                PORT.ed25519.Ed25519PrivKey(_seed("client", 2)), b"a=b")
            await cl.call("broadcast_tx_sync",
                          tx=base64.b64encode(tx).decode())
            await _until(lambda: node.block_store.height >= 3, "height 3")
            port = node.pprof_port
            launches = json.loads(await _get(port, "/debug/launches"))
            status = json.loads(await _get(port, "/status"))
            trace = json.loads(await _get(port, "/debug/trace?seconds=60"))
            return launches, status, trace
        finally:
            await node.stop()

    launches, status, trace = run(go())
    recs = [r for r in launches["records"] if r["workload"] == "admission"]
    assert len(recs) == 1
    assert recs[0]["kernel"] == "general"
    assert recs[0]["backend"] == "cpu-fallback"
    assert recs[0]["lanes"] == 2 and recs[0]["capacity"] == 128
    assert recs[0]["verdict"] == "ok" and recs[0]["ok_lanes"] == 2
    assert launches["rollup"]["workloads"]["admission"]["launches"] == 1
    assert launches["watchdog"]["effective_backend"] == "cpu_fallback"
    dev = status["checks"]["device"]
    assert dev["effective_backend"] == "cpu_fallback"
    assert dev["configured_backend"] == "auto" and dev["status"] == "ok"
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"consensus.height", "consensus.commit", "state.apply_block",
            "crypto.verify"} <= names
    assert trace["tm_tpu"]["dropped"] == 0


# -- the fault rule ----------------------------------------------------------


@pytest.mark.parametrize("fault", [KernelError, NoDeviceError])
def test_a_port_fault_under_broadcast_tx_sync_halts_the_node(fault,
                                                             tmp_path,
                                                             monkeypatch):
    """ROADMAP Queue C: the admission launch under broadcast_tx_sync
    raises; the request gets an internal error (the reference's route
    answers "tx rejected"), the node halts through Switch.halt and
    wait_halted re-raises the fault."""
    def raising(*a, **kw):
        raise fault("the admission launch failed")

    monkeypatch.setattr(pverify, "verify_batch", raising)

    async def go():
        node = make_node(PORT, tmp_path, 0, 1,
                         mempool={"admission_flush_ms": 0.0})
        await node.start()
        try:
            node.mempool.admission.collector.device_threshold = 1
            cl = PORT.jsonrpc.HTTPClient("127.0.0.1", node.rpc_port)
            tx = PORT.envelope.sign_tx(
                PORT.ed25519.Ed25519PrivKey(_seed("client", 1)), b"k=v")
            with pytest.raises(PORT.jsonrpc.RPCError) as err:
                await cl.call("broadcast_tx_sync",
                              tx=base64.b64encode(tx).decode())
            with pytest.raises(fault):
                await node.wait_halted(timeout=DEADLINE_S)
            return err.value, node.switch.is_running
        finally:
            if node.is_running:
                await node.stop()

    err, running = run(go())
    assert (err.code, err.message) == (-32603, "internal error")
    assert not running


class _Provider:
    """A state provider the node never reaches: the syncer is replaced."""


@pytest.mark.parametrize("fault", [KernelError, NoDeviceError, RuntimeError])
def test_state_sync_faults_halt_where_others_fall_back(fault, tmp_path):
    """ROADMAP Queue C: a port fault out of state sync halts the node
    and re-raises; any other failure falls back to fast sync, as the
    reference's _run_state_sync does for every exception."""

    async def go():
        node = make_node(PORT, tmp_path, 0, 2,
                         base={"fast_sync": True},
                         statesync={"enable": True, "trust_height": 1})
        node.state_provider_factory = lambda n: _Provider()
        await node._build()

        async def sync():
            raise fault("a light check's launch failed")

        node.ss_reactor.sync = sync
        await node.start()
        try:
            if fault is RuntimeError:
                await _until(lambda: node.bc_reactor.fast_sync, "fast sync")
                return "fell back", node.switch.fault
            with pytest.raises(fault):
                await node.wait_halted(timeout=DEADLINE_S)
            return "halted", node.bc_reactor.fast_sync
        finally:
            if node.is_running:
                await node.stop()

    got = run(go())
    if fault is RuntimeError:
        assert got == ("fell back", None)
    else:
        assert got == ("halted", False)
