"""The port's JSON-RPC server (tendermint_tpu_torch/rpc/jsonrpc.py) held
against the JAX package's: one table of raw requests goes to a port
JSONRPCServer and to a reference one over the same echo routes, and the
bytes that come back must be equal — POST, batch, URI GET with quoted
and 0x params, an unknown method, params that are not a map, a bad
arity, an oversized body, malformed HTTP, the limiter's busy answer, and
WebSocket subscribe/unsubscribe. Then the port's fault rule: a
KernelError or NoDeviceError under a handler answers the request with an
internal error and reaches `on_fault`, where the reference only answers.
No kernel runs here."""

from __future__ import annotations

import asyncio
import json

import pytest

from tendermint_tpu.rpc import jsonrpc as rjsonrpc
from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.device import NoDeviceError
from tendermint_tpu_torch.rpc import jsonrpc as pjsonrpc

PACKAGES = {"port": pjsonrpc, "reference": rjsonrpc}


def run(coro):
    return asyncio.run(coro)


def _typed(v):
    return [type(v).__name__, v]


async def echo(ctx, **params):
    """Each param with the type the server coerced it to."""
    return {k: _typed(v) for k, v in sorted(params.items())}


async def add(ctx, a, b):
    return a + b


async def boom(ctx):
    raise ValueError("a handler bug")


async def rpc_error(ctx, code=-32000):
    raise PACKAGES[ctx.package].RPCError(int(code), "refused", "because")


def routes(package: str) -> dict:
    """The same handlers for both servers; `rpc_error` raises the
    package's own RPCError."""

    def tag(fn):
        async def handler(ctx, **params):
            ctx.package = package
            return await fn(ctx, **params)
        return handler

    return {"echo": echo, "add": add, "boom": boom,
            "rpc_error": tag(rpc_error)}


def ws_routes() -> dict:
    async def subscribe(ctx, query=""):
        ctx.ws.send_json({"jsonrpc": "2.0", "id": None,
                          "result": {"query": query, "data": "event"}})
        return {}

    async def unsubscribe(ctx, query=""):
        return {"unsubscribed": query}

    return {"subscribe": subscribe, "unsubscribe": unsubscribe}


def _post(body: bytes, extra: bytes = b"") -> bytes:
    return (b"POST / HTTP/1.1\r\nHost: rpc\r\nContent-Type: application/json"
            b"\r\nConnection: close\r\n" + extra + b"Content-Length: " +
            str(len(body)).encode() + b"\r\n\r\n" + body)


def _get(target: str) -> bytes:
    return (b"GET " + target.encode() +
            b" HTTP/1.1\r\nHost: rpc\r\nConnection: close\r\n\r\n")


def _call(method, params=None, id_=1) -> bytes:
    req = {"jsonrpc": "2.0", "id": id_, "method": method}
    if params is not None:
        req["params"] = params
    return json.dumps(req).encode()


TABLE = {
    "post": _post(_call("echo", {"a": 1, "s": "x", "t": True})),
    "post_no_params": _post(_call("echo")),
    "batch": _post(b"[" + _call("echo", {"x": 1}, 1) + b"," +
                   _call("add", {"a": 2, "b": 3}, 2) + b"," +
                   _call("nope", {}, 3) + b", 7]"),
    "uri_get": _get("/echo?n=42&zero=0012&flag=true&f=false"),
    "uri_quoted": _get('/echo?tx=%22k%3Dv%22&empty=%22%22'),
    "uri_hex": _get("/echo?data=0xdeadbeef&plain=abc"),
    "uri_index": _get("/"),
    "unknown_method": _post(_call("no_such_route", {})),
    "params_not_a_map": _post(_call("echo", [1, 2])),
    "bad_arity": _post(_call("add", {"a": 1})),
    "handler_error": _post(_call("boom", {})),
    "rpc_error": _post(_call("rpc_error", {"code": -32001})),
    "parse_error": _post(b"{not json"),
    "not_an_object": _post(b"17"),
    "unsupported_verb": (b"PUT / HTTP/1.1\r\nHost: rpc\r\nConnection: close"
                         b"\r\nContent-Length: 2\r\n\r\n{}"),
    "oversized_body": _post(b"x" * 2048),
    "malformed_request_line": b"GARBAGE\r\n\r\n",
    "ws_only_route_over_http": _post(_call("subscribe", {"query": "q"})),
}


async def _exchange(port: int, raw: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(raw)
        await writer.drain()
        return await asyncio.wait_for(reader.read(-1), 10)
    finally:
        writer.close()


async def _serve(package: str, **kw):
    srv = PACKAGES[package].JSONRPCServer(routes(package), ws_routes(),
                                          max_body=1024, **kw)
    return srv, await srv.listen("127.0.0.1", 0)


def _answers(package: str) -> dict:
    async def go():
        srv, port = await _serve(package)
        try:
            return {name: await _exchange(port, raw)
                    for name, raw in TABLE.items()}
        finally:
            srv.close()

    return run(go())


_ANSWERS: dict = {}


def answers(package: str) -> dict:
    if package not in _ANSWERS:
        _ANSWERS[package] = _answers(package)
    return _ANSWERS[package]


@pytest.mark.parametrize("case", sorted(TABLE))
def test_the_request_table_gets_the_reference_answers(case):
    got, want = answers("port")[case], answers("reference")[case]
    assert got == want
    if case in ("oversized_body", "malformed_request_line"):
        assert got == b""  # the connection closes unanswered
    else:
        assert got.startswith(b"HTTP/1.1 200 OK\r\n")


def test_uri_params_keep_their_provenance():
    body = answers("port")["uri_quoted"].partition(b"\r\n\r\n")[2]
    assert json.loads(body)["result"] == {"empty": ["RawStr", ""],
                                          "tx": ["RawStr", "k=v"]}
    body = answers("port")["uri_get"].partition(b"\r\n\r\n")[2]
    assert json.loads(body)["result"] == {
        "f": ["bool", False], "flag": ["bool", True], "n": ["int", 42],
        "zero": ["UriStr", "0012"]}


def _limited(package: str) -> list:
    """A server at one request a second: the first request and the
    first element of a batch pass, every further one is refused."""

    async def go():
        srv, port = await _serve(package, rate_limit_rps=1.0)
        try:
            out = [await _exchange(port, TABLE["post"])]
            out.append(await _exchange(port, TABLE["post"]))
            out.append(await _exchange(port, TABLE["batch"]))
            return out
        finally:
            srv.close()

    return run(go())


def test_the_limiters_busy_answer_equals_the_reference():
    got, want = _limited("port"), _limited("reference")
    assert got == want
    busy = json.loads(got[1].partition(b"\r\n\r\n")[2])
    assert busy["error"]["code"] == pjsonrpc.CODE_BUSY
    assert busy["error"]["data"] == "rate"


def _concurrency(package: str) -> tuple:
    """max_concurrent=1: a request parked in a handler makes the next
    one busy ("concurrency"), and a request after it passes again."""

    async def go():
        gate = asyncio.Event()

        async def park(ctx):
            await gate.wait()
            return "released"

        srv = PACKAGES[package].JSONRPCServer({"park": park, "echo": echo},
                                              max_concurrent=1)
        port = await srv.listen("127.0.0.1", 0)
        try:
            parked = asyncio.ensure_future(
                _exchange(port, _post(_call("park", {}))))
            while srv._in_flight == 0:
                await asyncio.sleep(0.005)
            busy = await _exchange(port, TABLE["post"])
            gate.set()
            return busy, await parked, await _exchange(port, TABLE["post"])
        finally:
            srv.close()

    return run(go())


def test_the_concurrency_limit_equals_the_reference():
    got = _concurrency("port")
    assert got == _concurrency("reference")
    assert json.loads(got[0].partition(b"\r\n\r\n")[2])["error"]["data"] == \
        "concurrency"
    assert json.loads(got[1].partition(b"\r\n\r\n")[2])["result"] == \
        "released"


def _websocket(package: str, client_package: str) -> list:
    """subscribe (a notification pushed, then its answer), a
    ws-only route's answer, unsubscribe, and a plain route, through
    `client_package`'s WSClient."""

    async def go():
        srv, port = await _serve(package)
        closed = []
        srv._on_ws_close = lambda ws: closed.append(True)
        cl = PACKAGES[client_package].WSClient("127.0.0.1", port)
        await cl.connect()
        try:
            out = [await cl.call("subscribe", query="tm.event='Tx'")]
            out.append(await asyncio.wait_for(cl.events.get(), 5))
            out.append(await cl.call("echo", x=1))
            out.append(await cl.call("unsubscribe", query="tm.event='Tx'"))
            try:
                await cl.call("no_such_route")
            except PACKAGES[client_package].RPCError as e:
                out.append((e.code, e.message))
        finally:
            cl.close()
        for _ in range(200):
            if closed:
                break
            await asyncio.sleep(0.01)
        srv.close()
        return out + [closed]

    return run(go())


@pytest.mark.parametrize("client", sorted(PACKAGES))
def test_websocket_subscribe_and_unsubscribe_equal_the_reference(client):
    got = _websocket("port", client)
    assert got == _websocket("reference", client)
    assert got[1]["result"] == {"query": "tm.event='Tx'", "data": "event"}
    assert got[-1] == [True]


@pytest.mark.parametrize("client", sorted(PACKAGES))
def test_http_client_reads_both_servers_alike(client):
    async def go(package):
        srv, port = await _serve(package)
        try:
            cl = PACKAGES[client].HTTPClient("127.0.0.1", port)
            out = [await cl.call("echo", a=1, b="x")]
            try:
                await cl.call("rpc_error", code=-32005)
            except PACKAGES[client].RPCError as e:
                out.append((e.code, e.message, e.data))
            return out
        finally:
            srv.close()

    assert run(go("port")) == run(go("reference")) == [
        {"a": ["int", 1], "b": ["str", "x"]}, (-32005, "refused", "because")]


@pytest.mark.parametrize("fault", [KernelError, NoDeviceError])
def test_a_port_fault_under_a_handler_reaches_on_fault(fault):
    """The fault rule at the server: the request is answered with an
    internal error and the fault goes to on_fault; the reference's
    server answers the same error and keeps nothing."""

    async def faulty(ctx):
        raise fault("the admission launch failed")

    async def go(package):
        seen = []
        kw = {"on_fault": seen.append} if package == "port" else {}
        srv = PACKAGES[package].JSONRPCServer({"faulty": faulty}, **kw)
        port = await srv.listen("127.0.0.1", 0)
        try:
            raw = await _exchange(port, _post(_call("faulty", {})))
        finally:
            srv.close()
        return json.loads(raw.partition(b"\r\n\r\n")[2]), seen

    got, seen = run(go("port"))
    want, _ = run(go("reference"))
    assert got["error"]["code"] == want["error"]["code"] == -32603
    assert got["error"]["message"] == "internal error"
    assert [type(e) for e in seen] == [fault]
