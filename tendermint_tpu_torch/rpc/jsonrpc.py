"""Minimal asyncio HTTP/1.1 + WebSocket JSON-RPC server and clients
(reference: rpc/jsonrpc.py; Go rpc/jsonrpc/server/http_json_handler.go,
ws_handler.go).

One listener serves three surfaces, like the reference:
  POST /            JSON-RPC 2.0 (single or batch)
  GET  /<method>?k=v  URI routes (params as query strings)
  GET  /websocket   WebSocket upgrade; JSON-RPC frames; server pushes
                    subscription events as jsonrpc notifications

Handlers are `async fn(ctx, **params) -> dict`; the registry maps
method name → handler. Stdlib-only.

Counts go into the reference's rpc family (libs/metrics.py): requests
rejected by reason, the requests in flight, and the websocket events a
slow client lost. GET /metrics serves the Prometheus exposition of the
whole catalog here too, for one-port deployments.

The port's fault rule (crypto/batch.py UNCAUGHT): a ``KernelError`` or
``NoDeviceError`` raised under a handler answers that request with an
internal error and is handed to the server's ``on_fault`` (a node
halts through ``Switch.halt``); it is never only a logged error as in
the reference's ``_call_one``."""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import time
import urllib.parse

from ..crypto.batch import UNCAUGHT
from ..libs.metrics import rpc_metrics
from ..libs.overload import CONTROLLER, DropOldestQueue

logger = logging.getLogger("rpc.server")

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_BODY = 1_000_000
# 429-style JSON-RPC error code for overload-limiter rejections (the
# JSON-RPC spec reserves no code for this; the HTTP status number is
# the conventional vocabulary and greppable in client logs).
CODE_BUSY = 429
# Bound on a WSClient's buffered notifications: a slow consumer loses
# the OLDEST events (counted in rpc_ws_events_dropped_total), never
# grows memory without limit.
WS_EVENTS_MAX = 1024


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        self.code = code
        self.message = message
        self.data = data
        super().__init__(message)


def _rpc_error(id_, code, message, data=""):
    err = {"code": code, "message": message}
    if data:
        err["data"] = data
    return {"jsonrpc": "2.0", "id": id_, "error": err}


def _rpc_result(id_, result):
    return {"jsonrpc": "2.0", "id": id_, "result": result}


class WSConnection:
    """Server side of one upgraded websocket (RFC6455, server never
    masks; close/ping handled inline)."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def read_frame(self) -> tuple[int, bytes] | None:
        try:
            hdr = await self.reader.readexactly(2)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        opcode = hdr[0] & 0x0F
        masked = hdr[1] & 0x80
        ln = hdr[1] & 0x7F
        if ln == 126:
            ln = int.from_bytes(await self.reader.readexactly(2), "big")
        elif ln == 127:
            ln = int.from_bytes(await self.reader.readexactly(8), "big")
        if ln > MAX_BODY:
            return None
        mask = await self.reader.readexactly(4) if masked else b""
        payload = await self.reader.readexactly(ln) if ln else b""
        if masked:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return opcode, payload

    def send_frame(self, payload: bytes, opcode: int = 0x1) -> None:
        if self.closed:
            return
        ln = len(payload)
        if ln < 126:
            hdr = bytes([0x80 | opcode, ln])
        elif ln < 1 << 16:
            hdr = bytes([0x80 | opcode, 126]) + ln.to_bytes(2, "big")
        else:
            hdr = bytes([0x80 | opcode, 127]) + ln.to_bytes(8, "big")
        self.writer.write(hdr + payload)

    def send_json(self, obj) -> None:
        self.send_frame(json.dumps(obj).encode())

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.send_frame(b"", opcode=0x8)
                self.writer.close()
            except Exception:
                pass


class JSONRPCServer:
    def __init__(self, routes: dict, ws_routes: dict | None = None,
                 max_body: int = MAX_BODY, max_concurrent: int = 0,
                 rate_limit_rps: float = 0.0, on_fault=None):
        """routes: name → async fn(ctx, **params). ws_routes: extra
        routes only valid on a websocket (subscribe/unsubscribe); their
        ctx gets .ws set. max_concurrent / rate_limit_rps (0 = off)
        shed excess requests with a 429-style error instead of
        queueing them — protecting the event loop, which also runs
        consensus, from an RPC flood. on_fault(exc) takes a port fault
        (UNCAUGHT) met under a handler."""
        self.routes = routes
        self.ws_routes = ws_routes or {}
        self.max_body = max_body
        self.max_concurrent = max_concurrent
        self.rate_limit_rps = rate_limit_rps
        self._in_flight = 0
        self._tokens = float(max(rate_limit_rps, 1.0))
        self._tokens_t = time.monotonic()
        self._server: asyncio.AbstractServer | None = None
        self._on_ws_close = None
        self.on_fault = on_fault
        if max_concurrent > 0:
            CONTROLLER.register("rpc.http", lambda: self._in_flight,
                                max_concurrent, owner=self)

    # -- overload limiter --

    def _admit(self) -> str | None:
        """None to admit; otherwise the rejection reason. Concurrency
        is checked FIRST so a request rejected for concurrency does
        not also burn a rate token — rejected traffic must not eat
        the budget of future legitimate requests. One token per
        admitted request, ~1 s of burst."""
        if 0 < self.max_concurrent <= self._in_flight:
            return "concurrency"
        if self.rate_limit_rps > 0:
            now = time.monotonic()
            # burst cap never below one whole token: a sub-1 rps limit
            # must still admit a request every 1/rate seconds, not
            # reject everything forever
            self._tokens = min(
                max(self.rate_limit_rps, 1.0),
                self._tokens + (now - self._tokens_t)
                * self.rate_limit_rps)
            self._tokens_t = now
            if self._tokens < 1.0:
                return "rate"
            self._tokens -= 1.0
        return None

    def _reject(self, id_, reason: str) -> dict:
        rpc_metrics().requests_rejected.inc(reason=reason)
        CONTROLLER.shed("rpc.http")
        return _rpc_error(id_, CODE_BUSY,
                          "server overloaded; retry later", reason)

    def _gauge_in_flight(self) -> None:
        rpc_metrics().requests_in_flight.set(self._in_flight)

    async def listen(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._serve_conn, host,
                                                  port)
        return self._server.sockets[0].getsockname()[1]

    def close(self) -> None:
        CONTROLLER.unregister("rpc.http", owner=self)
        if self._server is not None:
            self._server.close()

    # -- connection handling --

    async def _serve_conn(self, reader, writer) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, target, headers, body = req
                if headers.get("upgrade", "").lower() == "websocket":
                    await self._serve_websocket(reader, writer, headers)
                    return
                if method == "GET" and target.partition("?")[0] == "/metrics":
                    # Prometheus text exposition (the reference serves it
                    # on the instrumentation listener and here too)
                    keep = headers.get("connection", "").lower() != "close"
                    self._write_metrics(writer, keep)
                    await writer.drain()
                    if not keep:
                        break
                    continue
                reason = self._admit()
                if reason is not None:
                    resp, keep = self._reject(None, reason), True
                else:
                    self._in_flight += 1
                    self._gauge_in_flight()
                    try:
                        resp, keep = await self._dispatch_http(
                            method, target, body)
                    finally:
                        self._in_flight -= 1
                        self._gauge_in_flight()
                if headers.get("connection", "").lower() == "close":
                    keep = False
                self._write_response(writer, resp, keep)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("rpc connection handler died")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _write_metrics(writer, keep: bool) -> None:
        from ..libs.metrics import DEFAULT, node_metrics

        node_metrics()  # the full catalog on every scrape
        text = DEFAULT.render_text().encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/plain; version=0.0.4\r\n"
            + f"Content-Length: {len(text)}\r\n".encode()
            + (b"Connection: keep-alive\r\n" if keep
               else b"Connection: close\r\n")
            + b"\r\n" + text)

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _ = line.decode().split(" ", 2)
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        ln = int(headers.get("content-length", 0))
        if ln > self.max_body:
            return None
        body = await reader.readexactly(ln) if ln else b""
        return method, target, headers, body

    def _write_response(self, writer, payload: dict | list,
                        keep: bool) -> None:
        body = json.dumps(payload).encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"Connection: " + (b"keep-alive" if keep else b"close") +
            b"\r\n\r\n" + body)

    # -- dispatch --

    async def _dispatch_http(self, method: str, target: str, body: bytes):
        if method == "POST":
            try:
                req = json.loads(body or b"{}")
            except json.JSONDecodeError as e:
                return _rpc_error(None, -32700, "parse error", str(e)), False
            if isinstance(req, list):
                # Per-element admission: the connection handler charged
                # ONE admission for the HTTP request, which covers the
                # first element — every further element must pass the
                # limiter itself, or a single 1 MB batch body would
                # smuggle thousands of calls past the rate bucket.
                out, first = [], True
                for r in req:
                    reason = None if first else self._admit()
                    first = False
                    if reason is not None:
                        out.append(self._reject(
                            r.get("id") if isinstance(r, dict) else None,
                            reason))
                    else:
                        out.append(await self._call_one(r, None))
                return out, True
            return await self._call_one(req, None), True
        if method == "GET":
            path, _, query = target.partition("?")
            name = path.strip("/")
            if not name:
                return self._index(), True
            params = {k: _uri_param(v[0]) for k, v in
                      urllib.parse.parse_qs(query).items()}
            return await self._call_one(
                {"jsonrpc": "2.0", "id": -1, "method": name,
                 "params": params}, None), True
        return _rpc_error(None, -32600, f"unsupported method {method}"), \
            False

    def _index(self) -> dict:
        return _rpc_result(-1, {
            "routes": sorted(self.routes) + sorted(self.ws_routes)})

    async def _call_one(self, req: dict, ws) -> dict:
        if not isinstance(req, dict):
            return _rpc_error(None, -32600, "invalid request")
        id_ = req.get("id")
        name = req.get("method", "")
        handler = self.routes.get(name)
        if handler is None and ws is not None:
            handler = self.ws_routes.get(name)
        if handler is None:
            return _rpc_error(id_, -32601, f"method {name!r} not found")
        params = req.get("params") or {}
        if not isinstance(params, dict):
            return _rpc_error(id_, -32602, "params must be a map")
        ctx = _Ctx(ws)
        try:
            result = await handler(ctx, **params)
            return _rpc_result(id_, result)
        except RPCError as e:
            return _rpc_error(id_, e.code, e.message, e.data)
        except TypeError as e:
            return _rpc_error(id_, -32602, f"invalid params: {e}")
        except UNCAUGHT as e:
            logger.error("handler %s met a port fault: %r", name, e)
            if self.on_fault is not None:
                self.on_fault(e)
            return _rpc_error(id_, -32603, "internal error", repr(e))
        except Exception as e:
            logger.exception("handler %s failed", name)
            return _rpc_error(id_, -32603, "internal error", str(e))

    # -- websocket --

    async def _serve_websocket(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key", "")
        accept = base64.b64encode(hashlib.sha1(
            (key + _WS_MAGIC).encode()).digest()).decode()
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept.encode() + b"\r\n\r\n")
        await writer.drain()
        ws = WSConnection(reader, writer)
        try:
            while True:
                frame = await ws.read_frame()
                if frame is None:
                    break
                opcode, payload = frame
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping
                    ws.send_frame(payload, opcode=0xA)
                    await writer.drain()
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                try:
                    req = json.loads(payload)
                except json.JSONDecodeError:
                    ws.send_json(_rpc_error(None, -32700, "parse error"))
                    continue
                reqs = req if isinstance(req, list) else [req]
                for r in reqs:
                    reason = self._admit()
                    if reason is not None:
                        ws.send_json(self._reject(
                            r.get("id") if isinstance(r, dict) else None,
                            reason))
                        continue
                    self._in_flight += 1
                    self._gauge_in_flight()
                    try:
                        ws.send_json(await self._call_one(r, ws))
                    finally:
                        self._in_flight -= 1
                        self._gauge_in_flight()
                await writer.drain()
        finally:
            if self._on_ws_close is not None:
                try:
                    self._on_ws_close(ws)
                except Exception:
                    logger.exception("ws close hook failed")
            ws.close()


class _Ctx:
    def __init__(self, ws):
        self.ws = ws


class RawStr(str):
    """A URI param that arrived in explicit quotes (`tx="vk=v"`).

    The reference's URI handler decodes quoted values as RAW content
    while the JSON-RPC path carries byte params base64-encoded
    (rpc/jsonrpc/server/http_uri_handler.go vs JSON unmarshalling).
    Handlers with byte-typed params need that provenance to pick the
    right decoding — this marker carries it across the generic
    param-coercion boundary."""


class UriStr(str):
    """An UNQUOTED string param that arrived via the URI interface.

    Byte-typed handlers accept `0x`-hex only from URI values (the
    reference's URI-handler convention); a JSON-RPC base64 payload
    that merely LOOKS like 0x-hex must never be hex-decoded, so the
    0x branch is gated on this provenance marker."""


def _uri_param(v: str):
    """URI params arrive as strings; JSON-ify the obvious scalars
    (reference uri handler's type coercion). Int-coerce ONLY when the
    round trip is lossless: "0012" must stay a string — an all-digit
    hex payload (e.g. abci_query data) with leading zeros would
    otherwise be silently corrupted downstream."""
    if v in ("true", "false"):
        return v == "true"
    if v.startswith('"') and v.endswith('"') and len(v) >= 2:
        return RawStr(v[1:-1])
    try:
        n = int(v)
    except ValueError:
        return UriStr(v)
    return n if str(n) == v else UriStr(v)


# --- clients ------------------------------------------------------------------


class HTTPClient:
    """Async JSON-RPC-over-HTTP client (Go reference: rpc/client/http)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._id = 0

    async def call(self, method: str, **params):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method, "params": params}).encode()
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(
                b"POST / HTTP/1.1\r\nHost: rpc\r\n"
                b"Content-Type: application/json\r\n"
                b"Connection: close\r\n"
                b"Content-Length: " + str(len(body)).encode() +
                b"\r\n\r\n" + body)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(-1), self.timeout)
        finally:
            writer.close()
        _, _, payload = raw.partition(b"\r\n\r\n")
        resp = json.loads(payload)
        if resp.get("error"):
            e = resp["error"]
            raise RPCError(e.get("code", -1), e.get("message", ""),
                           e.get("data", ""))
        return resp["result"]


async def relay_events(ws, get_msg, drain_timeout: float = 30.0) -> None:
    """Pump `await get_msg()` results to a downstream websocket with
    backpressure: a subscriber that stops reading must not buffer
    event JSON in memory forever — it gets disconnected after
    drain_timeout instead. Shared by the node's subscribe pump
    (rpc/core.py) and the light proxy's passthrough."""
    while True:
        try:
            msg = await get_msg()
        except asyncio.CancelledError:
            return
        ws.send_json(msg)
        try:
            await asyncio.wait_for(ws.writer.drain(), drain_timeout)
        except (asyncio.TimeoutError, ConnectionError):
            ws.close()
            return


def _count_ws_event_drop() -> None:
    rpc_metrics().ws_events_dropped.inc()


class WSClient:
    """Websocket JSON-RPC client with a BOUNDED notification queue
    (Go reference: rpc/jsonrpc/client/ws_client.go)."""

    def __init__(self, host: str, port: int,
                 events_max: int = WS_EVENTS_MAX):
        self.host = host
        self.port = port
        # Bounded drop-OLDEST buffer: a subscriber that stops reading
        # loses history (counted), not the process's memory. Newest
        # events win — they are the ones a catching-up consumer needs.
        self.events = DropOldestQueue(events_max, queue="rpc.ws_events",
                                      on_drop=_count_ws_event_drop)
        self._pending: dict[int, asyncio.Future] = {}
        self._id = 0
        self._task = None

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        key = base64.b64encode(b"0123456789abcdef").decode()
        self.writer.write(
            b"GET /websocket HTTP/1.1\r\nHost: rpc\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Key: " + key.encode() +
            b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
        await self.writer.drain()
        while True:  # consume the 101 response headers
            line = await self.reader.readline()
            if line in (b"\r\n", b""):
                break
        self._ws = WSConnection(self.reader, self.writer)
        self._task = asyncio.get_running_loop().create_task(
            self._recv_loop(), name="ws-client-recv")

    async def call(self, method: str, timeout: float = 10.0, **params):
        self._id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[self._id] = fut
        self._send_json({"jsonrpc": "2.0", "id": self._id,
                         "method": method, "params": params})
        await self.writer.drain()
        return await asyncio.wait_for(fut, timeout)

    def _send_json(self, obj) -> None:
        # clients MUST mask frames (RFC6455 §5.3)
        payload = json.dumps(obj).encode()
        import os as _os

        mask = _os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        ln = len(masked)
        if ln < 126:
            hdr = bytes([0x81, 0x80 | ln])
        elif ln < 1 << 16:
            hdr = bytes([0x81, 0x80 | 126]) + ln.to_bytes(2, "big")
        else:
            hdr = bytes([0x81, 0x80 | 127]) + ln.to_bytes(8, "big")
        self.writer.write(hdr + mask + masked)

    async def _recv_loop(self) -> None:
        try:
            while True:
                frame = await self._ws.read_frame()
                if frame is None:
                    break
                opcode, payload = frame
                if opcode != 0x1:
                    continue
                msg = json.loads(payload)
                id_ = msg.get("id")
                fut = self._pending.pop(id_, None) if id_ is not None \
                    else None
                if fut is not None and not fut.done():
                    if msg.get("error"):
                        e = msg["error"]
                        fut.set_exception(RPCError(
                            e.get("code", -1), e.get("message", ""),
                            e.get("data", "")))
                    else:
                        fut.set_result(msg.get("result"))
                else:
                    self.events.put_nowait(msg)  # drop-oldest when full
        except (ConnectionError, asyncio.CancelledError):
            pass

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        self.events.close()  # drop the overload-controller registration
        try:
            self.writer.close()
        except Exception:
            pass
