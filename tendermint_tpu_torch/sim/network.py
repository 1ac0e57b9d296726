"""Seeded in-memory network model for the simulation harness (reference:
tendermint_tpu/sim/network.py).

Every node's SimTransport registers a listener here; frames written to
a SimConn are delivered to the remote endpoint by ``loop.call_at`` on
the VIRTUAL clock after the link's sampled latency — per-link seeded
RNGs (derived from ``(network seed, src host, dst host)`` via sha256,
never Python's randomized ``hash()``) make delivery times a pure
function of the seed. Delivery per direction is FIFO (a later frame
never overtakes an earlier one — the stream abstraction MConnection
sits on), so jitter stretches inter-frame gaps instead of reordering
fragments.

Fault surface:

  * ``partition(groups)`` — hosts in different groups cannot dial each
    other and every established cross-group connection is RESET (the
    hard-sever shape, like Switch.sever(): remotes see a dead conn and
    run the real reconnect/backoff machinery, not a silent stall).
  * ``set_link_down(a, b)`` — single-link flap, same semantics.
  * ``LinkSpec.loss`` — per-frame probability that the CONNECTION
    dies (an authenticated stream cannot lose one frame and survive,
    so loss manifests as stream death + reconnect churn; keep it
    small).
  * node churn is modeled above this layer (SimNode.stop/start — the
    listener disappears, dials are refused).
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from collections import deque
from dataclasses import dataclass


class SimNetError(ConnectionError):
    pass


@dataclass(frozen=True)
class LinkSpec:
    """One direction of a WAN link, sampled per frame."""

    latency_ms: float = 40.0
    jitter_ms: float = 10.0
    loss: float = 0.0            # per-frame P(connection reset)
    bandwidth_bps: float = 0.0   # 0 = unlimited

    def validate(self) -> None:
        if self.latency_ms < 0 or self.jitter_ms < 0:
            raise ValueError("latency/jitter must be >= 0")
        if not 0.0 <= self.loss <= 1.0:
            raise ValueError("loss must be in [0, 1]")
        if self.bandwidth_bps < 0:
            raise ValueError("bandwidth must be >= 0")


def derive_seed(*parts) -> int:
    """Stable integer seed from arbitrary labels — sha256, NOT
    ``hash()`` (which is salted per process and would silently
    de-determinize every link RNG)."""
    blob = ":".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")


class _Link:
    """Directed delivery lane a→b: seeded RNG + FIFO high-water."""

    def __init__(self, spec: LinkSpec, seed: int):
        self.spec = spec
        self.rng = random.Random(seed)
        self.next_free = 0.0  # virtual time the lane is busy until

    def deliver_at(self, nbytes: int, now: float) -> float:
        s = self.spec
        d = s.latency_ms / 1000.0
        if s.jitter_ms:
            d += self.rng.uniform(0.0, s.jitter_ms / 1000.0)
        if s.bandwidth_bps:
            d += nbytes * 8.0 / s.bandwidth_bps
        at = now + d
        if at <= self.next_free:
            # STRICTLY after the previous frame: equal call_at
            # deadlines are tie-broken arbitrarily by the timer heap,
            # which reorders fragments of one stream (observed as
            # truncated/garbled messages at 20+ nodes)
            at = self.next_free + 1e-9
        self.next_free = at
        return at

    def lost(self) -> bool:
        return self.spec.loss > 0 and self.rng.random() < self.spec.loss

    def one_way_s(self) -> float:
        return self.spec.latency_ms / 1000.0


class SimConn:
    """One endpoint of an in-memory duplex connection. Presents the
    frame surface MConnection needs from a SecretConnection
    (write_frame/read_frame/drain/close) with delivery scheduled on
    the virtual clock through the owning SimNetwork's link models."""

    def __init__(self, network: "SimNetwork", local_host: str,
                 remote_host: str):
        self.network = network
        self.local_host = local_host
        self.remote_host = remote_host
        self.peer: "SimConn | None" = None  # set by SimNetwork.connect
        self._queue: deque[bytes] = deque()
        self._rx = asyncio.Event()
        self.closed = False

    # -- sending --

    def write_frame(self, payload: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("sim conn closed")
        net = self.network
        if net.blocked(self.local_host, self.remote_host):
            # a partition landed under an in-flight writer
            self.reset()
            if self.peer is not None:
                self.peer.reset()
            raise ConnectionResetError("sim partition")
        link = net.link(self.local_host, self.remote_host)
        loop = asyncio.get_running_loop()
        if link.lost():
            net.stats["frames_lost"] += 1
            peer = self.peer
            if peer is not None:
                loop.call_later(link.one_way_s(), peer.reset)
            self.reset()
            raise ConnectionResetError("sim frame loss")
        at = link.deliver_at(len(payload), loop.time())
        net.stats["frames"] += 1
        net.stats["bytes"] += len(payload)
        loop.call_at(at, self.peer._push, bytes(payload))

    async def drain(self) -> None:
        return

    # -- receiving --

    def _push(self, data: bytes) -> None:
        if self.closed:
            return  # arrived after the endpoint died: lost on the floor
        self._queue.append(data)
        self._rx.set()

    async def read_frame(self) -> bytes:
        while True:
            if self._queue:
                return self._queue.popleft()
            if self.closed:
                raise ConnectionResetError("sim conn closed")
            self._rx.clear()
            await self._rx.wait()

    # -- teardown --

    def reset(self) -> None:
        """Abrupt death (partition/loss/remote close): readers raise,
        writers raise, queued-but-undelivered frames vanish."""
        if self.closed:
            return
        self.closed = True
        self._rx.set()
        self.network.conns.pop(self, None)
        self.network.stats["conn_resets"] += 1

    def close(self) -> None:
        """Local close; the remote notices one link latency later
        (its reader raises), like a FIN/RST reaching it."""
        if self.closed:
            return
        self.closed = True
        self._rx.set()
        self.network.conns.pop(self, None)
        peer = self.peer
        if peer is None or peer.closed:
            return
        lat = self.network.link(
            self.local_host, self.remote_host).one_way_s()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # closing outside the loop (final cleanup)
            peer.reset()
            return
        loop.call_later(lat, peer.reset)


class SimNetwork:
    """The routing fabric: listeners, link models, partitions, stats."""

    def __init__(self, seed: int = 0,
                 default_link: LinkSpec | None = None,
                 links: dict | None = None):
        self.seed = seed
        self.default_link = default_link or LinkSpec()
        self.default_link.validate()
        # {frozenset({host_a, host_b}): LinkSpec} overrides
        self.link_specs = {frozenset(k): v for k, v in (links or {}).items()}
        self._links: dict[tuple[str, str], _Link] = {}
        self.listeners: dict[tuple[str, int], object] = {}
        # dict-as-ordered-set: reset/close iterate in INSERTION
        # order (the deterministic connect order), never in the
        # id()-hash order a set would give — reset order feeds the
        # reconnect/backoff draw order, so it must be reproducible
        self.conns: dict[SimConn, None] = {}
        self._groups: list[set[str]] | None = None
        self._down_links: set[frozenset] = set()
        self.stats = {"frames": 0, "bytes": 0, "frames_lost": 0,
                      "conn_resets": 0, "dials_refused": 0}

    # -- links --

    def link(self, a: str, b: str) -> _Link:
        key = (a, b)
        ln = self._links.get(key)
        if ln is None:
            spec = self.link_specs.get(frozenset((a, b)), self.default_link)
            ln = self._links[key] = _Link(
                spec, derive_seed("link", self.seed, a, b))
        return ln

    # -- fault surface --

    def blocked(self, a: str, b: str) -> bool:
        if a == b:
            return False
        if frozenset((a, b)) in self._down_links:
            return True
        groups = self._groups
        if groups is None:
            return False
        ga = gb = None
        for i, g in enumerate(groups):
            if a in g:
                ga = i
            if b in g:
                gb = i
        return ga != gb

    def partition(self, groups) -> int:
        """Install a partition (list of host groups; hosts absent from
        every group land in an implicit extra group). Returns the
        number of connections reset."""
        self._groups = [set(g) for g in groups]
        return self._reset_blocked()

    def heal(self) -> None:
        self._groups = None

    def set_link_down(self, a: str, b: str, down: bool = True) -> int:
        key = frozenset((a, b))
        if down:
            self._down_links.add(key)
            return self._reset_blocked()
        self._down_links.discard(key)
        return 0

    def _reset_blocked(self) -> int:
        n = 0
        for conn in list(self.conns):
            if self.blocked(conn.local_host, conn.remote_host):
                conn.reset()
                n += 1
        return n

    # -- listeners + connection setup --

    def listen(self, host: str, port: int, transport) -> None:
        key = (host, port)
        if key in self.listeners:
            raise SimNetError(f"sim addr {host}:{port} already bound")
        self.listeners[key] = transport

    def unlisten(self, host: str, port: int) -> None:
        self.listeners.pop((host, port), None)

    def connect(self, src_host: str, dst_host: str,
                dst_port: int) -> tuple[SimConn, SimConn]:
        """A connected (client_end, server_end) pair, or raises like a
        refused/partitioned dial. The caller (SimTransport.dial)
        performs the NodeInfo handshake and hands the server end to
        the listener's accept queue."""
        if self.blocked(src_host, dst_host):
            self.stats["dials_refused"] += 1
            raise SimNetError(
                f"sim dial {src_host} -> {dst_host} blocked by partition")
        if (dst_host, dst_port) not in self.listeners:
            self.stats["dials_refused"] += 1
            raise SimNetError(
                f"sim dial {dst_host}:{dst_port}: nothing listening")
        a = SimConn(self, src_host, dst_host)
        b = SimConn(self, dst_host, src_host)
        a.peer, b.peer = b, a
        self.conns[a] = None
        self.conns[b] = None
        return a, b

    def close(self) -> None:
        for conn in list(self.conns):
            conn.reset()
        self.listeners.clear()
