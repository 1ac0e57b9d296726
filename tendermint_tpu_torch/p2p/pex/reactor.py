"""PEX (peer exchange) reactor on channel 0x00 (reference:
p2p/pex/reactor.py; Go p2p/pex/pex_reactor.go:24). The wire format
(JSON messages) and the timestamped flood strikes are the reference's.

Outbound-hungry nodes ask peers for addresses; peers answer with a
random book selection (rate-limited per peer). ensure_peers dials from
the book until max_outbound is met. Seed mode: accept, share
addresses, hang up (pex_reactor.go seed logic).
"""

from __future__ import annotations

import asyncio
import json
import time

from ..conn.connection import ChannelDescriptor
from ..switch import Reactor
from .addrbook import AddrBook

PEX_CHANNEL = 0x00

_MSG_REQUEST = "pex_request"
_MSG_ADDRS = "pex_addrs"

# Request rate limits SCALE with ensure_period (one knob; prod default
# 30 s -> receiver bar 60 s, sender spacing 90 s — the reference's
# fixed numbers). Sender-side spacing exceeds the receiver's bar with
# margin, and must survive reconnects: in a small net the book never
# fills, the ensure loop re-requests forever, and `_requested` used to
# reset on every reconnect — two innocent requests under the receiver
# bar once degenerated the whole net into mutual flood-flagging
# (observed starving a kill -9'd node's catch-up for 9+ minutes in a
# soak run). Tests that set pex_ensure_period_s get proportional
# limits for free instead of needing a second knob.
#
# The sender/receiver invariant only holds when peers run comparable
# ensure_periods, so over-rate requests are NOT immediately fatal: the
# receiver IGNORES mildly-early requests (a peer with a faster local
# config just gets no answer) and only flags a flood after
# _FLOOD_STRIKES over-rate requests inside one bar — keeping the DoS
# guard without letting config skew sever healthy links.
_ENSURE_PERIOD = 30.0
_REQUEST_INTERVAL_FACTOR = 2.0   # receiver: min seconds between reqs
_REQUEST_SPACING_FACTOR = 3.0    # sender: spacing > receiver bar
_FLOOD_STRIKES = 3


class PEXReactor(Reactor):
    def __init__(self, book: AddrBook, seed_mode: bool = False,
                 seeds: list[str] | None = None,
                 ensure_period: float = _ENSURE_PERIOD):
        super().__init__("pex")
        self.book = book
        self.seed_mode = seed_mode
        self.seeds = seeds or []
        self.ensure_period = ensure_period
        self.request_interval = _REQUEST_INTERVAL_FACTOR * ensure_period
        self.request_send_spacing = \
            _REQUEST_SPACING_FACTOR * ensure_period
        self._last_request_from: dict[str, float] = {}
        # peer.id -> monotonic timestamps of over-rate requests still
        # inside the current bar (strikes older than request_interval
        # expire — see receive())
        self._flood_strikes: dict[str, list[float]] = {}
        self._requested: set[str] = set()
        # NOT cleared on remove_peer: rate limit outlives reconnects
        self._last_request_to: dict[str, float] = {}
        self._task = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10, name="pex")]

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._ensure_peers_routine())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        self.book.save()

    def init_peer(self, peer) -> None:
        pass

    async def add_peer(self, peer) -> None:
        if peer.outbound:
            # a dial succeeded: vet the address
            if peer.socket_addr:
                addr = f"{peer.id}@{peer.socket_addr}"
                self.book.add_address(addr, src=peer.id)
            self.book.mark_good(peer.id)
            return
        # Inbound: book the peer's self-reported LISTEN address
        # (reference pex_reactor.go AddPeer: srcAddrs from
        # NodeInfo.NetAddress). Without this, a rendezvous node (seed)
        # can never learn its dialers' addresses and discovery is
        # structurally impossible — found by a seed-bootstrap net
        # where every book stayed empty. The observed socket IP
        # replaces a wildcard/empty listen host.
        listen = getattr(getattr(peer, "node_info", None),
                         "listen_addr", "") or ""
        listen = listen[len("tcp://"):] if listen.startswith("tcp://") \
            else listen
        host, _, port = listen.rpartition(":")
        # bracketed IPv6 ("[::]:26656", "[fe80::1]:26656"): the book
        # and dialer use unbracketed hosts with last-colon splits
        host = host.strip("[]")
        if port.isdigit():
            if host in ("", "0.0.0.0", "::"):
                host = (peer.socket_addr or "") \
                    .rsplit(":", 1)[0].strip("[]")
            if host:
                self.book.add_address(f"{peer.id}@{host}:{port}",
                                      src=peer.id)
        if self._needs_more_peers():
            await self._request_addrs(peer)

    async def remove_peer(self, peer, reason) -> None:
        self._requested.discard(peer.id)
        self._last_request_from.pop(peer.id, None)
        self._flood_strikes.pop(peer.id, None)

    async def receive(self, chan_id: int, peer, msg: bytes) -> None:
        d = json.loads(msg)
        t = d.get("type")
        if t == _MSG_REQUEST:
            now = time.monotonic()
            last = self._last_request_from.get(peer.id, 0.0)
            if now - last < self.request_interval and not self.seed_mode:
                # Timestamped strikes, expiring after one bar
                # (request_interval) — matching the comment above:
                # flood = _FLOOD_STRIKES over-rate requests INSIDE ONE
                # BAR. The old integer counter reset on every accepted
                # request and never decayed otherwise, so a peer
                # pacing just under the bar could sustain a multiple
                # of the intended request rate forever by sneaking an
                # accepted request between strikes; conversely a
                # counter that never expired would eventually flag an
                # innocent config-skewed peer. Age-based expiry gives
                # both properties.
                strikes = [
                    t for t in self._flood_strikes.get(peer.id, ())
                    if now - t < self.request_interval
                ]
                strikes.append(now)
                self._flood_strikes[peer.id] = strikes
                if len(strikes) >= _FLOOD_STRIKES:
                    raise ValueError("pex request flood")
                return  # mildly early (config skew): ignore, no answer
            self._last_request_from[peer.id] = now
            sel = self.book.get_selection()
            await peer.send(PEX_CHANNEL, json.dumps(
                {"type": _MSG_ADDRS, "addrs": sel}).encode())
            if self.seed_mode and peer.outbound is False:
                # Seeds serve addresses then disconnect. receive() runs on
                # the peer's own mconn recv task, so the stop must go
                # through a fresh task or it cancels itself mid-teardown
                # (same invariant as Switch._on_peer_receive).
                sw = self.switch

                async def _drop(p=peer):
                    await asyncio.sleep(0.5)
                    await sw.stop_peer_gracefully(p)

                asyncio.get_running_loop().create_task(_drop())
        elif t == _MSG_ADDRS:
            if peer.id not in self._requested:
                raise ValueError("unsolicited pex addrs")
            self._requested.discard(peer.id)
            for a in d.get("addrs", [])[:100]:
                if isinstance(a, str):
                    self.book.add_address(a, src=peer.id)
        else:
            raise ValueError(f"unknown pex msg {t!r}")

    def _needs_more_peers(self) -> bool:
        sw = self.switch
        return sw is not None and sw._n_outbound() < sw.max_outbound

    async def _request_addrs(self, peer) -> None:
        now = time.monotonic()
        if now - self._last_request_to.get(peer.id, -1e9) < \
                self.request_send_spacing:
            return  # receiver would (rightly) flag us as flooding
        self._last_request_to[peer.id] = now
        self._requested.add(peer.id)
        await peer.send(PEX_CHANNEL,
                        json.dumps({"type": _MSG_REQUEST}).encode())

    async def _ensure_peers_routine(self) -> None:
        # dial seeds once if the book is empty
        if self.book.is_empty() and self.seeds:
            for s in self.seeds:
                self.book.add_address(s)
        while True:
            try:
                await self._ensure_peers()
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            await asyncio.sleep(self.ensure_period)

    async def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None or not self._needs_more_peers():
            return
        exclude = set(sw.peers) | {
            a.split("@", 1)[0] for a in sw.dialing if "@" in a}
        to_dial = sw.max_outbound - sw._n_outbound()
        picked = []
        for _ in range(to_dial):
            addr = self.book.pick_address(exclude=exclude)
            if addr is None:
                break
            exclude.add(addr.split("@", 1)[0])
            nid = addr.split("@", 1)[0]
            self.book.mark_attempt(nid)
            picked.append(addr)

        # Dial concurrently — serial dials to dead addresses would stall
        # peer acquisition by dial_timeout each (reference DialPeersAsync).
        async def _dial_one(a: str) -> None:
            try:
                await sw.dial_peer(a)
            except Exception:
                pass

        if picked:
            await asyncio.gather(*(_dial_one(a) for a in picked))
        # top up the book by asking a connected peer
        if self.book.size() < 16 and sw.peers:
            import random as _r

            peer = _r.choice(list(sw.peers.values()))
            if peer.id not in self._requested:
                await self._request_addrs(peer)
