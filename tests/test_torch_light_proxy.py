"""The port's light proxy (light/proxy.py LightProxy) and its serving pool
(light/serving.py ServingPool) held against the JAX package's, in the
shapes of tests/test_light_proxy.py.

Both packages build the same chain from the same seeds (the light client
tests' light_chain) and serve it through a proxy over real HTTP: the
verified routes' answers are equal, a forged block (a wrong block id, or
a forged body under the verified id) is refused with the reference's
error, and a verified abci_query (a MerkleKVStoreApp proof against the
verified header's app hash) accepts and refuses what the reference
does. A ServingPool's workers share one plane. The port's fault rule at
the proxy: a KernelError or NoDeviceError under a verification ends that
request with an internal error and reaches the proxy's owner (never
"light verification failed" or "not found"). No kernel runs: the chain's
four validators verify on the host, and the pool's device route is a
monkeypatched launch that raises."""

from __future__ import annotations

import asyncio
import base64
import types

import pytest
from test_torch_light_client import CHAIN, PACKAGES, client, light_chain

from tendermint_tpu.abci import kvstore as rkv
from tendermint_tpu.abci import types as rt
from tendermint_tpu import config as rconfig
from tendermint_tpu.libs import db as rdb
from tendermint_tpu.light import proxy as rproxy
from tendermint_tpu.light import serving as rserving
from tendermint_tpu.rpc import core as rcore
from tendermint_tpu.rpc import jsonrpc as rjsonrpc
from tendermint_tpu_torch.abci import kvstore as pkv
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.device import NoDeviceError, set_default_device
from tendermint_tpu_torch.libs import db as pdb
from tendermint_tpu_torch.light import proxy as pproxy
from tendermint_tpu_torch.light import serving as pserving
from tendermint_tpu_torch.rpc import core as pcore
from tendermint_tpu_torch.rpc import jsonrpc as pjsonrpc

RPC = {
    "port": types.SimpleNamespace(proxy=pproxy, serving=pserving,
                                  core=pcore, jsonrpc=pjsonrpc, kv=pkv, t=pt,
                                  db=pdb, config=pconfig),
    "reference": types.SimpleNamespace(proxy=rproxy, serving=rserving,
                                       core=rcore, jsonrpc=rjsonrpc, kv=rkv,
                                       t=rt, db=rdb, config=rconfig),
}


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    pbatch.reset_breakers()
    set_default_device(None)


def run(coro):
    return asyncio.run(coro)


async def _client(p, blocks):
    cl = client(p, blocks)
    await cl.initialize()
    return cl


def _answers(name: str) -> list:
    """The verified routes over HTTP, through `name`'s proxy."""
    p, r = PACKAGES[name], RPC[name]

    async def go():
        blocks = light_chain(p, 10)
        proxy = r.proxy.LightProxy(await _client(p, blocks))
        port = await proxy.listen("127.0.0.1", 0)
        http = r.jsonrpc.HTTPClient("127.0.0.1", port)
        out = []
        try:
            for method, params in (("commit", {"height": 7}),
                                   ("header", {"height": 9}),
                                   ("validators", {"height": 7,
                                                   "per_page": 2,
                                                   "page": 2}),
                                   ("status", {}), ("health", {}),
                                   ("commit", {"height": 40}),
                                   ("block", {"height": 7})):
                try:
                    out.append(await http.call(method, **params))
                except r.jsonrpc.RPCError as e:
                    out.append((e.code, e.message))
            out.append(blocks[7].hash().hex().upper())
            return out
        finally:
            proxy.close()

    return run(go())


def test_verified_routes_answer_as_the_reference():
    got = _answers("port")
    assert got == _answers("reference")
    assert got[0]["signed_header"]["commit"]["block_id"]["hash"] == got[-1]
    assert got[-2] == (-32601, "block pass-through not configured")
    assert got[-3][0] == -32603 and "light verification failed" in got[-3][1]


def _forged(name: str, body: bool) -> str:
    """The primary serves a block whose id (or, under the verified id,
    whose body) is not the verified header's."""
    p, r = PACKAGES[name], RPC[name]

    async def go():
        blocks = light_chain(p, 6)
        good = r.core._header_json(blocks[5].signed_header.header)

        class ForgingPrimary:
            async def call(self, method, **params):
                assert method == "block"
                if not body:
                    return {"block_id": {"hash": "ee" * 32}, "block": {}}
                return {"block_id": {"hash": blocks[5].hash().hex()},
                        "block": {"header": dict(good, app_hash="AA" * 32),
                                  "data": {"txs": []}}}

        proxy = r.proxy.LightProxy(await _client(p, blocks),
                                   forward_client=ForgingPrimary())
        try:
            await proxy.block(None, height=5)
        except r.jsonrpc.RPCError as e:
            return f"{e.code} {e.message}"
        return "relayed"

    return run(go())


@pytest.mark.parametrize("body", [False, True], ids=["block_id", "body"])
def test_a_forged_block_is_refused_as_the_reference_refuses_it(body):
    got = _forged("port", body)
    assert got == _forged("reference", body)
    assert got.startswith("-32603 ") and got != "relayed"


# -- the verified abci_query -----------------------------------------------


def _app(name: str):
    r = RPC[name]
    app = r.kv.MerkleKVStoreApp(r.db.MemDB())
    app.init_chain(r.t.RequestInitChain(chain_id=CHAIN))
    app.begin_block(r.t.RequestBeginBlock(hash=b"\x01" * 32))
    for tx in (b"alpha=1", b"beta=2", b"gamma=3"):
        app.deliver_tx(r.t.RequestDeliverTx(tx))
    app.end_block(r.t.RequestEndBlock(height=1))
    return app, app.commit(r.t.RequestCommit()).data


QUERIES = {
    "value": (b"beta", None),
    "absence": (b"delta", None),
    "tampered_value": (b"beta", "value"),
    "other_key": (b"beta", "key"),
    "no_proof": (b"beta", "proof"),
}


def _query(name: str, case: str) -> tuple:
    """A proxy whose primary answers abci_query from a MerkleKVStoreApp
    at height 4; its app hash is in header 5 of the verified chain."""
    p, r = PACKAGES[name], RPC[name]
    key, tamper = QUERIES[case]

    async def go():
        app, root = _app(name)
        blocks = light_chain(p, 8, app_hash=root)

        class Primary:
            host, port = "127.0.0.1", 0

            async def call(self, method, **params):
                assert method == "abci_query" and params["prove"]
                res = app.query(r.t.RequestQuery(
                    data=bytes.fromhex(params["data"]), prove=True))
                res.height = 4
                out = {"code": res.code, "log": res.log,
                       "index": str(res.index),
                       "key": base64.b64encode(res.key).decode(),
                       "value": base64.b64encode(res.value).decode(),
                       "height": str(res.height),
                       "proof_ops": {"ops": [
                           {"type": op["type"],
                            "key": base64.b64encode(op["key"]).decode(),
                            "data": base64.b64encode(op["data"]).decode()}
                           for op in res.proof_ops]}}
                if tamper == "value":
                    out["value"] = base64.b64encode(b"9").decode()
                elif tamper == "key":
                    out["key"] = base64.b64encode(b"alpha").decode()
                elif tamper == "proof":
                    out.pop("proof_ops")
                return {"response": out}

        proxy = r.proxy.LightProxy(await _client(p, blocks),
                                   forward_client=Primary())
        try:
            res = await proxy.abci_query(None, data=key.hex())
            return ("ok", res["response"]["log"], res["response"]["value"])
        except r.jsonrpc.RPCError as e:
            return ("refused", e.code, e.message)
        finally:
            proxy.close()

    return run(go())


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_a_verified_abci_query_as_the_reference(case):
    got = _query("port", case)
    assert got == _query("reference", case)
    if case in ("value", "absence"):
        assert got[0] == "ok"
    else:
        assert got[0] == "refused"


# -- the serving pool --------------------------------------------------------


def _pool(name: str) -> tuple:
    """Three workers over one plane: 24 concurrent requests spread over
    the workers and heights 2..9, each worker's answers equal."""
    p, r = PACKAGES[name], RPC[name]

    async def go():
        blocks = light_chain(p, 10)
        pool = r.serving.ServingPool(await _client(p, blocks), workers=3,
                                     config=r.config.LightConfig(flush_ms=5.0))
        pool.plane.collector.device_threshold = 10**9
        ports = await pool.listen("127.0.0.1")
        try:
            calls = [r.jsonrpc.HTTPClient("127.0.0.1", ports[i % 3]).call(
                "commit" if i % 2 else "validators", height=2 + i % 8)
                for i in range(24)]
            res = await asyncio.gather(*calls)
            return len(set(ports)), res, pool.plane.requests
        finally:
            pool.close()

    return run(go())


def test_the_serving_pool_answers_as_the_reference():
    n, got, requests = _pool("port")
    assert (n, got, requests) == _pool("reference")
    assert n == 3 and requests == 24


@pytest.mark.parametrize("fault", [KernelError, NoDeviceError])
def test_a_port_fault_under_a_proxy_verification_reaches_its_owner(
        fault, monkeypatch):
    """The fault rule: the request ends with an internal error, the
    proxy keeps the fault and its owner's on_fault gets it."""
    from tendermint_tpu_torch.types import validator_set

    def raising(*a, **kw):
        raise fault("a light check's launch failed")

    p = PACKAGES["port"]

    async def go():
        blocks = light_chain(p, 8)
        cl = client(p, blocks)
        await cl.initialize()
        monkeypatch.setattr(validator_set.CommitVerifyPlan, "execute",
                            raising)
        seen = []
        proxy = pproxy.LightProxy(cl, on_fault=seen.append)
        port = await proxy.listen("127.0.0.1", 0)
        try:
            with pytest.raises(pjsonrpc.RPCError) as e:
                await pjsonrpc.HTTPClient("127.0.0.1", port).call(
                    "commit", height=7)
            return e.value, proxy.fault, seen
        finally:
            proxy.close()

    err, kept, seen = run(go())
    assert (err.code, err.message) == (-32603, "internal error")
    assert isinstance(kept, fault) and seen == [kept]


@pytest.mark.parametrize("fault", [KernelError, NoDeviceError])
def test_a_port_fault_under_the_pools_launch_reaches_the_pool(fault,
                                                              monkeypatch):
    """The pool's plane launches (device route forced): the launch
    raises, the request ends with an internal error, the pool keeps the
    fault and its on_fault gets it; no breaker opens."""
    def raising(*a, **kw):
        raise fault("K4 failed")

    monkeypatch.setattr(pverify, "verify_batch", raising)
    p = PACKAGES["port"]

    async def go():
        blocks = light_chain(p, 8)
        seen = []
        pool = pserving.ServingPool(await _client(p, blocks), workers=2,
                                    config=pconfig.LightConfig(flush_ms=5.0),
                                    on_fault=seen.append)
        pool.plane.collector.device_threshold = 1
        ports = await pool.listen("127.0.0.1")
        try:
            with pytest.raises(pjsonrpc.RPCError) as e:
                await pjsonrpc.HTTPClient("127.0.0.1", ports[1]).call(
                    "validators", height=6)
            return e.value, pool.fault, seen
        finally:
            pool.close()

    err, kept, seen = run(go())
    assert (err.code, err.message) == (-32603, "internal error")
    assert isinstance(kept, fault) and seen == [kept]
    assert pbatch.device_available("ed25519")

