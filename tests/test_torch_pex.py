"""The port's peer exchange held against the JAX package's (no kernel
runs here): the address book's buckets, selection and JSON file value
for value under one salt and one random seed, a book saved by either
package loading in the other, the PEX reactor's request limits (the
sender's spacing across reconnects, the receiver's tolerance of skew,
and the timestamped flood strikes that expire), and over TCP on
127.0.0.1 a seed that answers and hangs up, an inbound peer's listen
address booked from its NodeInfo, and ensure_peers dialing from the
book until max_outbound. Each scenario runs on both packages; where the
outcome is a value the two are compared."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import json
import random
import types

import pytest

_MODULES = ("p2p.pex.addrbook", "p2p.pex.reactor", "p2p.key",
            "p2p.node_info", "p2p.switch", "p2p.transport", "crypto.ed25519")


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for mod in _MODULES:
        setattr(ns, mod.rsplit(".", 1)[-1],
                importlib.import_module(f"{root}.{mod}"))
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")
PKGS = [PORT, REF]
PKG_IDS = ["port", "reference"]
DEADLINE_S = 60.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def node_key(p, i: int):
    return p.key.NodeKey(p.ed25519.Ed25519PrivKey(
        hashlib.sha256(b"pex-key-%d" % i).digest()))


def addr(i: int) -> str:
    return f"{node_key(PORT, i).id}@127.0.0.1:{26000 + i}"


class FakePeer:
    def __init__(self, pid, outbound=False):
        self.id = pid
        self.outbound = outbound
        self.socket_addr = ""
        self.sent = []

    async def send(self, chan, msg):
        self.sent.append(msg)


class FakeSwitch:
    max_outbound = 10
    dialing: set = set()
    peers: dict = {}

    def _n_outbound(self):
        return 0


REQ = json.dumps({"type": "pex_request"}).encode()
ADDRS = [addr(i) for i in range(300)]


# -- the address book --------------------------------------------------------


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_addrbook_basics(p, tmp_path):
    book = p.addrbook.AddrBook(str(tmp_path / "addrbook.json"))
    nk = [node_key(p, i) for i in range(5)]
    for i, k in enumerate(nk):
        assert book.add_address(f"{k.id}@127.0.0.1:{26000 + i}")
    assert book.size() == 5
    assert not book.add_address(f"{nk[0].id}@127.0.0.1:26000")
    me = node_key(p, 99)
    book.add_our_address(me.id)
    assert not book.add_address(f"{me.id}@127.0.0.1:9")
    book.mark_good(nk[0].id)
    assert book.pick_address() is not None
    assert 1 <= len(book.get_selection()) <= 5
    for _ in range(3):
        book.mark_attempt(nk[1].id)
    assert all(nk[1].id not in a for a in book.get_selection(10))
    book.save()
    book2 = p.addrbook.AddrBook(str(tmp_path / "addrbook.json"))
    assert book2.size() == 5
    assert book2._addrs[nk[0].id].bucket_type == "old"


def _book_trace(p) -> list:
    """One script on a book with a fixed salt: buckets, picks and
    selections under one random seed, the bucket-full eviction."""
    book = p.addrbook.AddrBook(salt=b"\x05" * 8)
    out = []
    for i in range(40):
        out.append(book.add_address(addr(i), src=node_key(p, 1).id))
    for i in (3, 7, 11):
        book.mark_good(node_key(p, i).id)
    for _ in range(3):
        book.mark_attempt(node_key(p, 5).id)
    out.append(sorted((ka.addr, book._bucket(ka))
                      for ka in book._addrs.values()))
    random.seed(7)
    out.append([book.pick_address(new_bias_pct=b,
                                  exclude={node_key(p, 3).id})
                for b in (0, 30, 100) for _ in range(4)])
    random.seed(8)
    out.append([book.get_selection(n) for n in (1, 10, 50)])
    # a full bucket evicts its worst "new" entry
    p.addrbook.BUCKET_SIZE, size = 2, p.addrbook.BUCKET_SIZE
    try:
        full = p.addrbook.AddrBook(salt=b"\x00" * 8)
        by_bucket: dict = {}
        for a in ADDRS:
            by_bucket.setdefault(
                full._bucket(p.addrbook.KnownAddress(a)), []).append(a)
        mates = max(by_bucket.values(), key=len)[:3]
        for a in mates[:2]:
            full.add_address(a)
        full.mark_attempt(mates[1].split("@")[0])
        out.append((full.add_address(mates[2]), sorted(full._addrs)))
    finally:
        p.addrbook.BUCKET_SIZE = size
    return out


def test_books_agree_value_for_value():
    assert _book_trace(PORT) == _book_trace(REF)


@pytest.mark.parametrize("src,dst", [(PORT, REF), (REF, PORT)],
                         ids=["port-ref", "ref-port"])
def test_a_book_saved_by_one_package_loads_in_the_other(src, dst, tmp_path):
    path = str(tmp_path / "addrbook.json")
    book = src.addrbook.AddrBook(path, salt=b"\x09" * 8)
    for i in range(6):
        book.add_address(addr(i), src=node_key(src, 0).id)
    book.mark_good(node_key(src, 2).id)
    book.mark_attempt(node_key(src, 4).id)
    book.save()
    other = dst.addrbook.AddrBook(path)
    assert other.salt == book.salt
    assert {k: ka.to_json() for k, ka in other._addrs.items()} == \
        {k: ka.to_json() for k, ka in book._addrs.items()}
    assert [other._bucket(ka) for ka in other._addrs.values()] == \
        [book._bucket(ka) for ka in book._addrs.values()]
    other.save()
    with open(path) as f:
        assert json.load(f)["salt"] == book.salt.hex()


# -- the reactor's request limits ---------------------------------------------


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_pex_request_rate_limit_survives_reconnect(p):
    async def go():
        rx = p.reactor.PEXReactor(p.addrbook.AddrBook())
        rx.switch = FakeSwitch()
        peer = FakePeer("ab" * 20)
        await rx.add_peer(peer)
        assert len(peer.sent) == 1
        await rx.remove_peer(peer, "conn lost")
        await rx.add_peer(peer)
        assert len(peer.sent) == 1, "re-request inside flood window"
        await rx._request_addrs(peer)
        assert len(peer.sent) == 1
        rx._last_request_to[peer.id] -= rx.request_send_spacing + 1
        await rx._request_addrs(peer)
        assert len(peer.sent) == 2

    run(go())


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_pex_receiver_tolerates_skew_then_flags_flood(p):
    async def go():
        rx = p.reactor.PEXReactor(p.addrbook.AddrBook())
        peer = FakePeer("cd" * 20)
        ch = p.reactor.PEX_CHANNEL
        await rx.receive(ch, peer, REQ)   # in-rate: answered
        assert len(peer.sent) == 1
        await rx.receive(ch, peer, REQ)   # strike 1: ignored
        await rx.receive(ch, peer, REQ)   # strike 2: ignored
        assert len(peer.sent) == 1
        with pytest.raises(ValueError, match="flood"):
            await rx.receive(ch, peer, REQ)  # strike 3: flagged
        rx._last_request_from[peer.id] -= rx.request_interval + 1
        rx._flood_strikes.pop(peer.id, None)
        await rx.receive(ch, peer, REQ)
        assert len(peer.sent) == 2 and peer.id not in rx._flood_strikes

    run(go())


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_pex_strikes_decay_but_survive_accepts(p, monkeypatch):
    """Strikes older than one bar expire (a skewed peer is never
    flagged), and an accepted request does not reset them (a peer
    sustaining over-rate requests inside one bar is)."""
    clock = {"now": 1000.0}
    monkeypatch.setattr(p.reactor, "time", types.SimpleNamespace(
        monotonic=lambda: clock["now"]))

    async def recv_at(rx, peer, t):
        clock["now"] = t
        await rx.receive(p.reactor.PEX_CHANNEL, peer, REQ)

    async def go():
        rx = p.reactor.PEXReactor(p.addrbook.AddrBook(), ensure_period=0.5)
        assert rx.request_interval == 1.0
        flooder = FakePeer("ab" * 20)
        await recv_at(rx, flooder, 1000.0)    # accepted
        await recv_at(rx, flooder, 1000.30)   # strike 1
        await recv_at(rx, flooder, 1001.05)   # accepted (>= bar)
        await recv_at(rx, flooder, 1001.15)   # strike 2 (1 survives)
        with pytest.raises(ValueError, match="flood"):
            await recv_at(rx, flooder, 1001.25)
        assert len(flooder.sent) == 2
        skewed = FakePeer("cd" * 20)
        t = 2000.0
        await recv_at(rx, skewed, t)
        for _ in range(10):
            await recv_at(rx, skewed, t + 0.5)
            t += 1.5
            await recv_at(rx, skewed, t)
        assert len(skewed.sent) == 11
        return len(rx._flood_strikes.get(skewed.id, []))

    assert run(go()) <= 2


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_unsolicited_addrs_and_unknown_messages_are_peer_errors(p):
    async def go():
        rx = p.reactor.PEXReactor(p.addrbook.AddrBook())
        peer = FakePeer("ef" * 20)
        ch = p.reactor.PEX_CHANNEL
        with pytest.raises(ValueError, match="unsolicited"):
            await rx.receive(ch, peer, json.dumps(
                {"type": "pex_addrs", "addrs": [addr(1)]}).encode())
        with pytest.raises(ValueError, match="unknown pex msg"):
            await rx.receive(ch, peer, json.dumps({"type": "x"}).encode())
        # a solicited answer books at most 100 addresses
        rx._requested.add(peer.id)
        await rx.receive(ch, peer, json.dumps(
            {"type": "pex_addrs",
             "addrs": [addr(i) for i in range(120)] + [7]}).encode())
        return rx.book.size(), peer.id in rx._requested

    assert run(go()) == (100, False)


# -- over TCP -----------------------------------------------------------------


async def pex_switch(p, i: int, book=None, **pex):
    """A Switch on 127.0.0.1 with a PEXReactor alone (channel 0x00)."""
    nk = node_key(p, i)
    holder = {}

    def ni():
        t = holder["transport"]
        return p.node_info.NodeInfo(
            node_id=nk.id, listen_addr=t.listen_addr if t._server else "",
            network="pex-test", moniker=f"n{i}", channels=b"\x00")

    transport = p.transport.Transport(nk, ni)
    holder["transport"] = transport
    sw = p.switch.Switch(transport, ni, max_outbound=pex.pop("max_outbound",
                                                             10))
    book = book or p.addrbook.AddrBook()
    book.add_our_address(nk.id)
    rx = p.reactor.PEXReactor(book, **pex)
    sw.add_reactor("pex", rx)
    await transport.listen("127.0.0.1", 0)
    await sw.start()
    return sw, rx, f"{nk.id}@{transport.listen_addr}"


async def until(cond, what: str):
    for _ in range(1000):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(what)


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_a_seed_answers_then_hangs_up(p):
    """A node given only a seed: the seed answers its request with its
    book and hangs up; the seed books the node's listen address from its
    NodeInfo, and the node's book holds the seed's addresses."""
    async def go():
        known = [addr(i) for i in range(10, 13)]
        seed_book = p.addrbook.AddrBook()
        for a in known:
            seed_book.add_address(a)
        seed, seed_rx, seed_addr = await pex_switch(p, 1, seed_book,
                                                    seed_mode=True,
                                                    ensure_period=60.0)
        node, rx, node_addr = await pex_switch(p, 2, seeds=[seed_addr],
                                               ensure_period=0.2)
        dropped = []
        remove = seed._remove_peer

        async def recorded(peer, reason):
            dropped.append(str(reason))
            return await remove(peer, reason)

        seed._remove_peer = recorded
        try:
            await until(lambda: all(rx.book.has(a.split("@")[0])
                                    for a in known), "the seed's answer")
            await until(lambda: dropped, "the seed's hang-up")
            await until(lambda: not node.peers or seed.n_peers() == 0,
                        "the link's close")
            return (sorted(ka.addr for ka in seed_book._addrs.values()
                           if ka.addr not in known) == [node_addr],
                    dropped[0], rx.book.has(seed_addr.split("@")[0]),
                    rx.book._addrs[seed_addr.split("@")[0]].bucket_type)
        finally:
            await node.stop()
            await seed.stop()

    assert run(go()) == (True, "graceful stop", True, "old")


@pytest.mark.parametrize("p", PKGS, ids=PKG_IDS)
def test_ensure_peers_dials_from_the_book_until_max_outbound(p):
    async def go():
        servers = [await pex_switch(p, 20 + i, ensure_period=60.0)
                   for i in range(4)]
        book = p.addrbook.AddrBook()
        for _, _, a in servers:
            book.add_address(a)
        node, rx, _ = await pex_switch(p, 3, book, ensure_period=0.2,
                                       max_outbound=2)
        try:
            await until(lambda: node._n_outbound() == 2, "two dials")
            await asyncio.sleep(0.6)  # more ensure rounds: still two
            ids = {a.split("@")[0] for _, _, a in servers}
            return (node._n_outbound(), len(node.peers),
                    set(node.peers) <= ids,
                    sum(ka.bucket_type == "old"
                        for ka in book._addrs.values()))
        finally:
            await node.stop()
            for sw, _, _ in servers:
                await sw.stop()

    assert run(go()) == (2, 2, True, 2)
