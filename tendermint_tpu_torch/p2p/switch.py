"""Switch: peer lifecycle hub and reactor router (reference:
p2p/switch.py; Go p2p/switch.go:69).

Reactors register channel descriptors; inbound messages route to the
reactor owning that channel id. The switch runs the accept loop, dials
configured/persistent peers (with exponential backoff reconnect for
persistent ones, switch.go:393), de-duplicates by node id, and tears a
peer down on any reactor/connection error (StopPeerForError).

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError that reaches the switch (a
reactor's receive, through the peer's connection; a reactor's task
through ``halt``) is not a peer error. ``halt`` records it as
``fault``, hands it to every reactor's ``on_halt`` (the consensus
reactor halts its ConsensusState, whose wait_for_height re-raises it;
the blockchain reactor's wait_synced re-raises it) and stops the
switch; ``wait_halted`` re-raises it. The reference's
``_on_peer_receive`` stops the peer for any exception.
"""

from __future__ import annotations

import asyncio

from ..crypto.batch import UNCAUGHT
from ..libs.overload import CONTROLLER, SlowPeerPolicy, SlowPeerTracker
from ..libs.service import Service
from ..libs.metrics import p2p_metrics
from .conn.connection import ChannelDescriptor, MConnConfig
from .node_info import NodeInfo
from .peer import Peer
from .transport import Transport


class Reactor:
    """reference: p2p/base_reactor.go Reactor contract."""

    def __init__(self, name: str):
        self.name = name
        self.switch: "Switch | None" = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    def init_peer(self, peer: Peer) -> None:
        """Set up per-peer state before the connection starts."""

    async def add_peer(self, peer: Peer) -> None:
        """Peer is connected and started; begin gossip."""

    async def remove_peer(self, peer: Peer, reason) -> None:
        pass

    async def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        pass

    def on_halt(self, exc: BaseException) -> None:
        """The node halts on a port fault (Switch.halt); stop work."""

    def halt(self, exc: BaseException) -> None:
        """A reactor's own task met a port fault: halt the node through
        the switch (or, unattached, keep it for the caller)."""
        if self.switch is not None:
            self.switch.halt(exc)
        else:
            self.on_halt(exc)


class SwitchError(Exception):
    pass


class Switch(Service):
    def __init__(self, transport: Transport, node_info_fn,
                 mconn_config: MConnConfig | None = None,
                 max_inbound: int = 40, max_outbound: int = 10,
                 peer_filters: list | None = None,
                 slow_peer_policy: SlowPeerPolicy | None = None,
                 slow_peer_check_interval_s: float = 2.0):
        super().__init__(name="p2p.Switch")
        self.transport = transport
        self.node_info_fn = node_info_fn
        self.mconn_config = mconn_config
        # Post-handshake peer filters (reference node.go:452
        # PeerFilterFunc, e.g. ABCI /p2p/filter/id/<id> queries):
        # async f(node_info, socket_addr) -> error string to reject,
        # None to admit.
        self.peer_filters = list(peer_filters or [])
        self.reactors: dict[str, Reactor] = {}
        self.chan_to_reactor: dict[int, Reactor] = {}
        self.channels: list[ChannelDescriptor] = []
        self.peers: dict[str, Peer] = {}
        self.dialing: set[str] = set()          # addrs being dialed
        self.persistent_addrs: list[str] = []
        self.max_inbound = max_inbound
        self.max_outbound = max_outbound
        self._reconnect_tasks: dict[str, asyncio.Task] = {}
        # persistent-peer addrs abandoned after exhausting reconnect
        # attempts — flagged by the /status HealthMonitor p2p check and
        # counted in p2p_reconnect_exhausted_total; cleared when the
        # peer comes back (inbound or a later successful dial)
        self.reconnect_exhausted: set[str] = set()
        self._sever_until = 0.0                  # sever() test hook
        self.addr_book = None                    # set by PEX wiring
        self.reporter = None                     # behaviour.SwitchReporter
        # Optional peer interposer (sim byzantine conduct filters):
        # called with each freshly constructed Peer BEFORE reactors
        # see it; returns the (possibly wrapped/patched) peer.
        self.peer_wrapper = None
        # Slow-peer escalation: pending_send_bytes high-water strikes
        # -> skip-gossip -> demote -> disconnect (non-persistent). The
        # decision logic is the pure SlowPeerTracker; this class only
        # samples and enforces.
        self.slow_peers = SlowPeerTracker(slow_peer_policy)
        self.slow_peer_check_interval_s = slow_peer_check_interval_s
        self.fault: BaseException | None = None  # what halted the node
        self._halted = asyncio.Event()
        self._halting: asyncio.Task | None = None

    # -- assembly --

    def add_reactor(self, name: str, reactor: Reactor) -> None:
        for d in reactor.get_channels():
            if d.id in self.chan_to_reactor:
                raise SwitchError(f"channel {d.id:#x} claimed twice")
            self.chan_to_reactor[d.id] = reactor
            self.channels.append(d)
        reactor.switch = self
        self.reactors[name] = reactor

    def channel_ids(self) -> bytes:
        return bytes(sorted(d.id for d in self.channels))

    # -- lifecycle --

    async def on_start(self) -> None:
        for r in self.reactors.values():
            await r.start()
        self.spawn(self._accept_routine(), "switch-accept")
        if self.slow_peers.policy.pending_bytes_hiwater > 0:
            self.spawn(self._slow_peer_routine(), "switch-slow-peers")
        # aggregate p2p send-queue saturation for the overload level
        CONTROLLER.register(
            "p2p.send",
            lambda: sum(ch.queue.qsize()
                        for p in self.peers.values()
                        for ch in p.mconn.channels.values()),
            lambda: sum(ch.desc.send_queue_capacity
                        for p in self.peers.values()
                        for ch in p.mconn.channels.values()),
            owner=self)

    async def on_stop(self) -> None:
        CONTROLLER.unregister("p2p.send", owner=self)
        for t in self._reconnect_tasks.values():
            t.cancel()
        for peer in list(self.peers.values()):
            await self._remove_peer(peer, "switch stopping")
        for r in self.reactors.values():
            await r.stop()
        await self.transport.close()

    # -- the port's fault rule --

    def halt(self, exc: BaseException) -> None:
        """Halt the node on a port fault (UNCAUGHT): keep it as `fault`,
        tell every reactor, stop the switch; wait_halted re-raises."""
        if self.fault is None:
            self.fault = exc
            self.logger.error("node halted: %r", exc)
            for r in self.reactors.values():
                r.on_halt(exc)
        self._halted.set()
        if self.is_running and self._halting is None:
            self._halting = asyncio.get_running_loop().create_task(
                self.stop(), name="switch-halt")

    async def wait_halted(self, timeout: float | None = None) -> None:
        """Re-raise what halted the node once it halts (TimeoutError
        when it has not within `timeout`)."""
        await asyncio.wait_for(self._halted.wait(), timeout)
        if self._halting is not None:
            await asyncio.shield(self._halting)
        raise self.fault

    # -- inbound --

    async def _accept_routine(self) -> None:
        while True:
            conn, ni, sock_addr = await self.transport.accept()
            if self.severed():
                self.logger.info("severed: refusing inbound %s",
                                 ni.node_id[:12])
                conn.close()
                continue
            try:
                await self._add_peer(conn, ni, outbound=False,
                                     socket_addr=sock_addr)
            except Exception as e:
                self.logger.info("rejected inbound peer %s: %s",
                                 ni.node_id[:12], e)
                conn.close()

    def _n_inbound(self) -> int:
        return sum(1 for p in self.peers.values() if not p.outbound)

    def _n_outbound(self) -> int:
        return sum(1 for p in self.peers.values() if p.outbound)

    async def _add_peer(self, conn, ni: NodeInfo, outbound: bool,
                        persistent: bool = False, socket_addr: str = "") -> Peer:
        if ni.node_id == self.node_info_fn().node_id:
            raise SwitchError("connected to self")
        if ni.node_id in self.peers:
            raise SwitchError("duplicate peer")
        if not outbound and self._n_inbound() >= self.max_inbound:
            raise SwitchError("max inbound peers")
        if outbound and not persistent and \
                self._n_outbound() >= self.max_outbound:
            raise SwitchError("max outbound peers")
        for f in self.peer_filters:
            err = await f(ni, socket_addr)
            if err is not None:
                raise SwitchError(f"peer filtered: {err}")
        peer = Peer(conn, ni, self.channels,
                    on_receive=self._on_peer_receive,
                    on_error=self._on_peer_error,
                    outbound=outbound, persistent=persistent,
                    socket_addr=socket_addr, mconn_config=self.mconn_config,
                    on_fault=self.halt)
        if self.peer_wrapper is not None:
            peer = self.peer_wrapper(peer) or peer
        for r in self.reactors.values():
            r.init_peer(peer)
        await peer.start()
        # Re-check after the await: a simultaneous cross-dial can land a
        # second conn for the same node id while this one was starting;
        # check+insert below is atomic (no await between them).
        if ni.node_id in self.peers:
            await peer.stop()
            raise SwitchError("duplicate peer (cross-dial race)")
        self.peers[ni.node_id] = peer
        # a peer that came back on its own un-flags its abandoned
        # reconnect (it may dial US after a long partition heals)
        if self.reconnect_exhausted:
            self.reconnect_exhausted = {
                a for a in self.reconnect_exhausted
                if _split_addr(a)[0] != ni.node_id}
        for r in self.reactors.values():
            try:
                await r.add_peer(peer)
            except Exception as e:
                await self.stop_peer_for_error(peer, e)
                raise
        self.logger.info("added peer %r (%d total)", peer, len(self.peers))
        p2p_metrics().peers.set(len(self.peers))
        return peer

    # -- outbound --

    # -- network severance (test hook; reference analogue:
    # test/e2e/runner/perturb.go:12-60 severs the docker network) --

    def severed(self) -> bool:
        return asyncio.get_running_loop().time() < self._sever_until

    async def sever(self, duration_s: float) -> int:
        """Hard TCP disconnect: close every peer connection both ways
        (remotes observe a connection RESET, not a stall) and refuse
        dials/accepts for `duration_s`. Reconnect then runs through
        the real persistent-peer backoff and PEX re-discovery paths.
        Returns the number of connections dropped."""
        self._sever_until = asyncio.get_running_loop().time() + duration_s
        dropped = 0
        for peer in list(self.peers.values()):
            await self.stop_peer_for_error(
                peer, "network severed (test hook)")
            dropped += 1
        self.logger.info("severed network for %.1fs (%d conns dropped)",
                         duration_s, dropped)
        return dropped

    async def dial_peer(self, addr: str, persistent: bool = False) -> Peer | None:
        """addr = 'host:port' or 'id@host:port'."""
        expect_id, hostport = _split_addr(addr)
        if self.severed():
            raise SwitchError("network severed (test hook)")
        if addr in self.dialing:
            return None
        self.dialing.add(addr)
        try:
            host, port = hostport.rsplit(":", 1)
            conn, ni = await self.transport.dial(host, int(port))
            try:
                if expect_id and ni.node_id != expect_id:
                    raise SwitchError(
                        f"dialed {addr} but peer is {ni.node_id[:12]}")
                return await self._add_peer(conn, ni, outbound=True,
                                            persistent=persistent,
                                            socket_addr=hostport)
            except Exception:
                conn.close()
                raise
        finally:
            self.dialing.discard(addr)

    async def dial_peers_async(self, addrs: list[str],
                               persistent: bool = False) -> None:
        async def one(a):
            try:
                await self.dial_peer(a, persistent=persistent)
            except Exception as e:
                self.logger.info("dial %s failed: %s", a, e)
                if persistent:
                    self._schedule_reconnect(a)

        await asyncio.gather(*(one(a) for a in addrs))

    def add_persistent_peers(self, addrs: list[str]) -> None:
        self.persistent_addrs.extend(addrs)

    # -- slow-peer escalation --

    async def _slow_peer_routine(self) -> None:
        while True:
            await asyncio.sleep(self.slow_peer_check_interval_s)
            try:
                await self._scan_slow_peers()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.logger.exception("slow-peer scan failed")

    async def _scan_slow_peers(self) -> list[tuple[str, str]]:
        """One monitoring pass: strike peers whose unsent backlog sits
        at the high-water mark, enforce the tracker's escalation
        transitions. A peer that cannot drain is distinguishable from
        a dead one precisely because its conn is alive while
        pending_send_bytes stays pinned — the ping/pong keepalive
        never fires, so without this a wedged-but-breathing peer holds
        its gossip slots forever. Returns [(peer_id, action)] for
        tests/ops."""
        actions: list[tuple[str, str]] = []
        for peer in list(self.peers.values()):
            pending = peer.pending_send_bytes()
            action = self.slow_peers.observe(peer.id, pending,
                                             peer.is_persistent())
            if action is None:
                continue
            actions.append((peer.id, action))
            p2p_metrics().slow_peer_events.inc(action=action)
            peer.slow_level = self.slow_peers.level(peer.id)
            self.logger.warning(
                "slow peer %r: %s (pending %dB, draining %.0fB/s)",
                peer, action, pending, peer.send_rate())
            if action == "disconnect":
                await self.stop_peer_for_error(
                    peer, f"slow peer: {pending}B pending send backlog")
        return actions

    # -- teardown --

    def _on_peer_error(self, peer: Peer, exc: Exception) -> None:
        asyncio.get_running_loop().create_task(
            self.stop_peer_for_error(peer, exc))

    async def stop_peer_for_error(self, peer: Peer, reason) -> None:
        if peer.id not in self.peers:
            return
        self.logger.info("stopping peer %r: %s", peer, reason)
        await self._remove_peer(peer, reason)
        p2p_metrics().peers.set(len(self.peers))
        if peer.is_persistent() and self.is_running:
            addr = f"{peer.id}@{peer.socket_addr}" if peer.socket_addr else None
            for a in self.persistent_addrs:
                if _split_addr(a)[0] == peer.id:
                    addr = a
                    break
            if addr:
                self._schedule_reconnect(addr)

    async def stop_peer_gracefully(self, peer: Peer) -> None:
        await self._remove_peer(peer, "graceful stop")

    async def _remove_peer(self, peer: Peer, reason) -> None:
        self.peers.pop(peer.id, None)
        self.slow_peers.forget(peer.id)
        if self.reporter is not None:
            self.reporter.disconnected(peer.id)  # pause its trust metric
        for r in self.reactors.values():
            try:
                await r.remove_peer(peer, reason)
            except Exception:
                self.logger.exception("reactor remove_peer failed")
        await peer.stop()

    def _schedule_reconnect(self, addr: str) -> None:
        if addr in self._reconnect_tasks and \
                not self._reconnect_tasks[addr].done():
            return

        async def reconnect():
            # exponential backoff (reference: reconnectToPeer switch.go:393)
            from ..libs.net import jittered_backoff

            for attempt in range(20):
                delay = jittered_backoff(attempt, 5, 300)
                await asyncio.sleep(delay if attempt else 1.0)
                expect_id, _ = _split_addr(addr)
                if expect_id and expect_id in self.peers:
                    self.reconnect_exhausted.discard(addr)
                    return
                try:
                    await self.dial_peer(addr, persistent=True)
                    self.reconnect_exhausted.discard(addr)
                    return
                except Exception as e:
                    self.logger.info("reconnect %s attempt %d failed: %s",
                                     addr, attempt + 1, e)
            # Exhausted: the old behavior abandoned the peer SILENTLY
            # at info level — an operator learned a validator had been
            # partitioned only when consensus slowed. Loud error + a
            # counter + a /status flag instead.
            self.logger.error(
                "persistent peer %s unreachable after 20 reconnect "
                "attempts; giving up (flagged in /status)", addr)
            self.reconnect_exhausted.add(addr)
            p2p_metrics().reconnect_exhausted.inc()

        self._reconnect_tasks[addr] = self.spawn(reconnect(),
                                                 f"reconnect-{addr}")

    # -- routing --

    async def _on_peer_receive(self, peer: Peer, chan_id: int,
                               msg: bytes) -> None:
        # NB: this coroutine runs on the peer's own MConnection recv task.
        # Stopping the peer from here would cancel the very task we're on,
        # aborting stop_peer_for_error before it schedules the persistent
        # reconnect — so teardown always goes through a fresh task.
        reactor = self.chan_to_reactor.get(chan_id)
        if reactor is None:
            self._on_peer_error(
                peer, RuntimeError(f"msg on unregistered channel {chan_id:#x}"))
            return
        try:
            await reactor.receive(chan_id, peer, msg)
        except UNCAUGHT as e:
            # the port's own fault halts the node; the peer is not to
            # blame (the reference stops the peer for any exception)
            self.halt(e)
            raise
        except Exception as e:
            self.logger.warning("reactor %s receive error from %r: %s",
                                reactor.name, peer, e)
            self._on_peer_error(peer, e)

    # -- broadcast --

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        """Queue to every peer, non-blocking (reference switch.go:274)."""
        for peer in list(self.peers.values()):
            peer.try_send(chan_id, msg)

    def n_peers(self) -> int:
        return len(self.peers)


def _split_addr(addr: str) -> tuple[str, str]:
    """'id@host:port' → (id, 'host:port'); plain 'host:port' → ('', …)."""
    if "@" in addr:
        i, hp = addr.split("@", 1)
        return i, hp
    return "", addr
