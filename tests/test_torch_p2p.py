"""The port's p2p stack held against the JAX package's (no kernel runs
here): SecretConnection handshakes across the two packages in both
directions, sealed frames and MConnection packets byte for byte, a
port Switch and a reference Switch connecting over TCP (self and
duplicate rejection, an id mismatch, a peer filter, teardown), and the
flowrate monitor, the trust metric, DropOldestQueue, the slow-peer
tracker and the overload controller's advisory queues and shed window
value for value under one installed clock. Then the port's fault rule
at the switch and at the connection: a KernelError from a reactor's
receive halts the node instead of stopping the peer."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import types

import pytest

from tendermint_tpu_torch.crypto.cuda.kernels import KernelError

_MODULES = ("p2p.conn.secret_connection", "p2p.conn.connection",
            "p2p.conn_set", "p2p.key", "p2p.node_info", "p2p.switch",
            "p2p.transport", "p2p.trust", "libs.flowrate", "libs.overload",
            "libs.clock", "crypto.ed25519", "behaviour")


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for mod in _MODULES:
        setattr(ns, mod.rsplit(".", 1)[-1],
                importlib.import_module(f"{root}.{mod}"))
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")
PAIRS = [(PORT, REF), (REF, PORT)]
PAIR_IDS = ["port-ref", "ref-port"]
DEADLINE_S = 60.0


class Clock:
    """A monotonic source both packages read: it moves only when told."""

    def __init__(self):
        self.mono = 1000.0

    def monotonic(self) -> float:
        return self.mono

    def time_ns(self) -> int:
        return int(self.mono * 1e9)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for p in (PORT, REF):
        p.clock.uninstall()


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def seed(i: int) -> bytes:
    return hashlib.sha256(b"p2p-key-%d" % i).digest()


def key(p, i: int):
    return p.ed25519.Ed25519PrivKey(seed(i))


async def tcp_pair():
    loop = asyncio.get_running_loop()
    fut = loop.create_future()
    server = await asyncio.start_server(
        lambda r, w: fut.set_result((r, w)), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    c = await asyncio.open_connection("127.0.0.1", port)
    s = await fut
    return c, s, server


async def secret_pair(pa, pb):
    (cr, cw), (sr, sw), server = await tcp_pair()
    sa, sb = await asyncio.gather(
        pa.secret_connection.make_secret_connection(cr, cw, key(pa, 1)),
        pb.secret_connection.make_secret_connection(sr, sw, key(pb, 2)))
    return sa, sb, server


# -- SecretConnection --------------------------------------------------------


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_secret_connection_handshake_across_packages(pa, pb):
    async def go():
        sa, sb, server = await secret_pair(pa, pb)
        assert sa.remote_pubkey.bytes() == key(REF, 2).pub_key().bytes()
        assert sb.remote_pubkey.bytes() == key(REF, 1).pub_key().bytes()
        await sa.write_msg(b"hello")
        got = [await sb.read_msg()]
        await sb.write_msg(b"world")
        got.append(await sa.read_msg())
        big = bytes(range(256)) * 40  # spans eleven frames
        await sa.write_msg(big)
        got.append(await sb.read_msg())
        sa.close(); sb.close(); server.close()
        return got

    assert run(go()) == [b"hello", b"world", bytes(range(256)) * 40]


class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def test_sealed_frames_are_byte_for_byte_equal():
    """The same keys seal the same frames in both packages, and each
    opens the other's."""
    k1, k2 = b"\x01" * 32, b"\x02" * 32
    payloads = [b"", b"x", bytes(range(200)) * 5, b"\xff" * 1022]
    out = {}
    for p in (PORT, REF):
        sink = _Sink()
        sc = p.secret_connection.SecretConnection(None, sink, k1, k2)
        for pl in payloads:
            sc.write_frame(pl)
        out[p.name] = bytes(sink.data)
    assert out["tendermint_tpu_torch"] == out["tendermint_tpu"]
    assert len(out["tendermint_tpu"]) == len(payloads) * 1040

    async def opened(p, wire):
        reader = asyncio.StreamReader()
        reader.feed_data(wire)
        sc = p.secret_connection.SecretConnection(reader, _Sink(), k2, k1)
        return [await sc.read_frame() for _ in payloads]

    for p in (PORT, REF):
        assert asyncio.run(opened(p, out["tendermint_tpu"])) == payloads


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_secret_connection_tamper_detected(pa, pb):
    async def go():
        sa, sb, server = await secret_pair(pa, pb)
        # garbage straight onto the socket under the AEAD layer
        sa._writer.write(b"\x00" * 1040)
        await sa._writer.drain()
        try:
            await sb.read_msg()
        except Exception as e:  # InvalidTag from the AEAD
            err = type(e).__name__
        else:
            err = None
        sa.close(); sb.close(); server.close()
        return err

    assert run(go()) == "InvalidTag"


# -- MConnection -------------------------------------------------------------


class _FrameConn:
    """A SecretConnection stand-in that records plaintext packets."""

    def __init__(self):
        self.frames = []
        self._never = asyncio.Event()

    def write_frame(self, payload):
        self.frames.append(bytes(payload))

    async def drain(self):
        pass

    async def read_frame(self):
        await self._never.wait()

    def close(self):
        self._never.set()


def test_mconnection_packets_are_byte_for_byte_equal():
    """The same channel messages, queued before the send routine
    starts, leave as the same packets in the same order (the least
    recently-sent/priority channel first)."""
    msgs = [(0x20, b"state"), (0x21, b"P" * 2500), (0x22, b"vote"),
            (0x30, b"tx" * 700), (0x22, b"vote-2"), (0x21, b"")]

    async def go(p):
        c = p.connection
        clk = Clock()
        p.clock.install(clk)
        descs = [c.ChannelDescriptor(id=0x20, priority=6),
                 c.ChannelDescriptor(id=0x21, priority=10),
                 c.ChannelDescriptor(id=0x22, priority=7),
                 c.ChannelDescriptor(id=0x30, priority=5)]
        conn = _FrameConn()
        mc = c.MConnection(conn, descs, lambda ch, m: None)
        mc._started = True  # queue as a running connection would
        for ch, msg in msgs:
            assert mc.try_send(ch, msg)
        mc._started = False
        await mc.start()
        for _ in range(200):
            if not mc.pending_send_bytes():
                break
            await asyncio.sleep(0.005)
        await mc.stop()
        p.clock.uninstall()
        return conn.frames

    port, ref = asyncio.run(go(PORT)), asyncio.run(go(REF))
    assert port == ref and len(ref) == 9


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_mconnection_channels_across_packages(pa, pb):
    async def go():
        sa, sb, server = await secret_pair(pa, pb)
        got = asyncio.Queue()
        da = [pa.connection.ChannelDescriptor(id=0x20, priority=5),
              pa.connection.ChannelDescriptor(id=0x30, priority=1)]
        db = [pb.connection.ChannelDescriptor(id=0x20, priority=5),
              pb.connection.ChannelDescriptor(id=0x30, priority=1)]
        ma = pa.connection.MConnection(sa, da, lambda c, m: None)
        mb = pb.connection.MConnection(
            sb, db, lambda c, m: got.put_nowait((c, m)))
        await ma.start(); await mb.start()
        big = b"B" * 5000
        for ch, msg in ((0x20, b"vote"), (0x30, b"tx"), (0x20, big)):
            await ma.send(ch, msg)
        out = sorted([await got.get() for _ in range(3)])
        await ma.stop(); await mb.stop(); server.close()
        return out

    assert run(go()) == sorted([(0x20, b"vote"), (0x30, b"tx"),
                                (0x20, b"B" * 5000)])


def test_mconnection_unknown_channel_is_a_peer_error():
    async def go():
        c = PORT.connection
        sa, sb, server = await secret_pair(PORT, PORT)
        errs, faults = asyncio.Queue(), []
        ma = c.MConnection(sa, [c.ChannelDescriptor(id=0x20),
                                c.ChannelDescriptor(id=0x99)],
                           lambda ch, m: None)
        mb = c.MConnection(sb, [c.ChannelDescriptor(id=0x20)],
                           lambda ch, m: None, on_error=errs.put_nowait,
                           on_fault=faults.append)
        await ma.start(); await mb.start()
        await ma.send(0x99, b"mystery")
        e = await errs.get()
        await ma.stop(); await mb.stop(); server.close()
        return str(e), faults

    msg, faults = run(go())
    assert "unknown channel" in msg and faults == []


def test_a_kernel_error_in_on_receive_is_a_fault_not_a_peer_error():
    """The connection's receive routine hands a port fault to on_fault
    and ends; on_error (the peer's teardown) never fires. The reference
    reports every exception through on_error."""
    async def go(p, exc):
        c = p.connection
        sa, sb, server = await secret_pair(p, p)
        seen = asyncio.Queue()

        def boom(ch, m):
            raise exc

        kw = {"on_fault": lambda e: seen.put_nowait(("fault", e))} \
            if p is PORT else {}
        ma = c.MConnection(sa, [c.ChannelDescriptor(id=0x20)],
                           lambda ch, m: None)
        mb = c.MConnection(sb, [c.ChannelDescriptor(id=0x20)], boom,
                           on_error=lambda e: seen.put_nowait(("error", e)),
                           **kw)
        await ma.start(); await mb.start()
        await ma.send(0x20, b"x")
        kind, e = await seen.get()
        await asyncio.sleep(0.05)
        extra = seen.qsize()
        await ma.stop(); await mb.stop(); server.close()
        return kind, type(e).__name__, extra

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        ("fault", "KernelError", 0)
    assert run(go(REF, RuntimeError("injected"))) == \
        ("error", "RuntimeError", 0)


# -- Switch, Transport -------------------------------------------------------


def make_echo(p):
    class EchoReactor(p.switch.Reactor):
        """Echoes received messages back on their channel."""

        CHAN = 0x77

        def __init__(self):
            super().__init__("echo")
            self.received = asyncio.Queue()
            self.removed = []

        def get_channels(self):
            return [p.connection.ChannelDescriptor(id=self.CHAN,
                                                   priority=1)]

        async def remove_peer(self, peer, reason):
            self.removed.append(str(reason))

        async def receive(self, chan_id, peer, msg):
            self.received.put_nowait((peer.id, msg))
            if msg.startswith(b"ping:"):
                await peer.send(self.CHAN, b"echo:" + msg[5:])

    return EchoReactor()


async def make_switch(p, i: int, reactor=None):
    nk = p.key.NodeKey(key(p, i))
    holder = {}

    def ni():
        t = holder["transport"]
        return p.node_info.NodeInfo(
            node_id=nk.id, listen_addr=t.listen_addr if t._server else "",
            network="p2p-test", moniker=f"n{i}", channels=b"\x77")

    transport = p.transport.Transport(nk, ni)
    holder["transport"] = transport
    sw = p.switch.Switch(transport, ni)
    er = reactor or make_echo(p)
    sw.add_reactor("echo", er)
    await transport.listen("127.0.0.1", 0)
    await sw.start()
    return sw, er, nk


async def until(cond, what: str):
    for _ in range(400):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(what)


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_switches_across_packages_exchange(pa, pb):
    async def go():
        sw1, er1, nk1 = await make_switch(pa, 1)
        sw2, er2, nk2 = await make_switch(pb, 2)
        peer = await sw1.dial_peer(f"{nk2.id}@{sw2.transport.listen_addr}")
        await until(lambda: sw2.n_peers() == 1, "inbound peer")
        await peer.send(0x77, b"ping:hello")
        got = [await er2.received.get(), await er1.received.get()]
        sw2.broadcast(0x77, b"to-everyone")
        got.append(await er1.received.get())
        await sw1.stop_peer_for_error(peer, "test teardown")
        await until(lambda: sw2.n_peers() == 0, "remote teardown")
        out = (peer.id == nk2.id, got, sw1.n_peers(), er1.removed)
        await sw1.stop(); await sw2.stop()
        return out, nk1.id, nk2.id

    (same_id, got, n, removed), id1, id2 = run(go())
    assert same_id and n == 0 and removed == ["test teardown"]
    assert got == [(id1, b"ping:hello"), (id2, b"echo:hello"),
                   (id2, b"to-everyone")]


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_switch_rejects_self_duplicate_and_a_wrong_id(pa, pb):
    async def go():
        sw1, _, nk1 = await make_switch(pa, 1)
        sw2, _, nk2 = await make_switch(pb, 2)
        errs = []
        for addr in (f"{nk1.id}@{sw1.transport.listen_addr}",
                     f"{nk2.id}@{sw2.transport.listen_addr}",
                     f"{nk2.id}@{sw2.transport.listen_addr}",
                     f"{'ab' * 20}@{sw2.transport.listen_addr}"):
            try:
                await sw1.dial_peer(addr)
                errs.append(None)
            except Exception as e:
                errs.append(str(e))
        n = sw1.n_peers()
        await sw1.stop(); await sw2.stop()
        return errs, n

    errs, n = run(go())
    assert errs[0] == "connected to self" and errs[1] is None
    assert errs[2] == "duplicate peer"
    assert errs[3].startswith("dialed ") and "but peer is" in errs[3]
    assert n == 1


@pytest.mark.parametrize("pa,pb", PAIRS, ids=PAIR_IDS)
def test_a_peer_filter_keeps_the_peer_out(pa, pb):
    async def go():
        sw1, _, nk1 = await make_switch(pa, 1)
        sw2, _, nk2 = await make_switch(pb, 2)

        async def reject_all(ni, socket_addr):
            return "not on the list"

        sw2.peer_filters.append(reject_all)
        try:
            await sw2.dial_peer(f"{nk1.id}@{sw1.transport.listen_addr}")
            out = None
        except Exception as e:
            out = str(e)
        await sw1.dial_peer(f"{nk2.id}@{sw2.transport.listen_addr}")
        await until(lambda: sw1.n_peers() == 0, "filtered inbound dropped")
        n2 = sw2.n_peers()
        await sw1.stop(); await sw2.stop()
        return out, n2

    assert run(go()) == ("peer filtered: not on the list", 0)


def test_conn_set_and_the_duplicate_ip_filter_agree():
    def trace(p):
        cs_ = p.conn_set.ConnSet()
        a, b = object(), object()
        out = []
        cs_.add(a, "10.0.0.1")
        for ip in ("10.0.0.1", "10.0.0.2", "127.0.0.1"):
            try:
                p.conn_set.conn_duplicate_ip_filter(cs_, ip)
                out.append(None)
            except p.conn_set.ConnFilterError as e:
                out.append(str(e))
        cs_.add(b, "10.0.0.1")
        cs_.remove(a)
        out.append((cs_.has_ip("10.0.0.1"), cs_.count("10.0.0.1"), len(cs_)))
        cs_.remove(b)
        out.append((cs_.has_ip("10.0.0.1"), len(cs_)))
        return out

    assert trace(PORT) == trace(REF)


def test_node_keys_and_node_info_bytes_agree(tmp_path):
    ref_key = REF.key.NodeKey(key(REF, 3))
    ref_key.save(str(tmp_path / "node_key.json"))
    port_key = PORT.key.NodeKey.load(str(tmp_path / "node_key.json"))
    assert port_key.id == ref_key.id
    infos = [p.node_info.NodeInfo(node_id=ref_key.id, listen_addr="1.2.3.4:5",
                                  network="chain", channels=b"\x20\x40",
                                  moniker="m")
             for p in (PORT, REF)]
    assert infos[0].to_bytes() == infos[1].to_bytes()
    back = PORT.node_info.NodeInfo.from_bytes(infos[1].to_bytes())
    back.validate_basic()
    other = REF.node_info.NodeInfo(node_id=ref_key.id, network="other")
    assert back.compatible_with(other) == infos[1].compatible_with(other)


# -- flowrate, trust, overload ---------------------------------------------


def test_flowrate_monitor_values_agree():
    def trace(p):
        clk = Clock()
        p.clock.install(clk)
        m = p.flowrate.Monitor(sample_period=0.1, window=1.0)
        out = []
        for step, n in enumerate((100, 5000, 0, 70_000, 12, 900, 4000)):
            clk.mono += 0.03 * (step + 1)
            m.update(n)
            out.append((m.rate, m.total, m.limit(3000, 10_000),
                        m.sleep_time(10_000)))
        p.clock.uninstall()
        return out

    assert trace(PORT) == trace(REF)


def test_trust_metric_and_store_values_agree():
    def trace(p):
        clk = Clock()
        p.clock.install(clk)
        store = p.trust.TrustMetricStore(interval_s=10.0)
        out = []
        for step in range(40):
            for peer, (good, bad) in (("a", (3, step % 4 == 0)),
                                      ("b", (1, 2)), ("c", (step, 0))):
                m = store.get_metric(peer)
                m.good_events(good)
                if bad:
                    m.bad_events(bad)
            if step == 17:
                store.peer_disconnected("b")
            clk.mono += 7.5
            store.maybe_tick()
            out.append(tuple(store.get_metric(x).trust_value()
                             for x in "abc"))
        saved = {pid: m.to_json() for pid, m in store.metrics.items()}
        p.clock.uninstall()
        return out, saved

    assert trace(PORT) == trace(REF)


def test_drop_oldest_queue_and_advisory_sheds_agree():
    def trace(p):
        clk = Clock()
        p.clock.install(clk)
        ctrl = p.overload.OverloadController(shed_window_s=2.0)
        q = p.overload.DropOldestQueue(4, queue="rpc.ws_events",
                                       controller=ctrl)
        out = []
        for i in range(7):
            q.put_nowait(i)
            out.append((q.qsize(), q.dropped, ctrl.evaluate()))
        ctrl.register("p2p.send", lambda: 19, 20)
        out.append(ctrl.evaluate())
        ctrl.shed("p2p.send")
        out.append(ctrl.level())
        clk.mono += 1.9
        out.append(ctrl.level())
        clk.mono += 0.2
        out.append(ctrl.level())
        out.append([q.get_nowait() for _ in range(4)])
        q.close()
        out.append(sorted(ctrl.evaluate()["queues"]))
        p.clock.uninstall()
        return out

    assert trace(PORT) == trace(REF)


def test_slow_peer_tracker_transitions_agree():
    def trace(p):
        tr = p.overload.SlowPeerTracker(p.overload.SlowPeerPolicy(
            pending_bytes_hiwater=100, skip_strikes=2, demote_strikes=3,
            disconnect_strikes=5))
        out = []
        for pending in (150, 150, 150, 10, 150, 150, 150, 150, 150, 150):
            out.append((tr.observe("a", pending, False), tr.level("a"),
                        tr.observe("b", pending, True), tr.level("b")))
        return out

    assert trace(PORT) == trace(REF)


# -- the fault rule at the switch ---------------------------------------------


def test_a_kernel_error_from_a_reactor_receive_halts_the_node():
    """A reactor's receive that raises a KernelError halts the port
    node: the switch stops, wait_halted re-raises the fault, every
    reactor's on_halt sees it, and the peer is not stopped for an
    error (no reconnect is scheduled). The reference stops the peer
    and runs on."""
    async def go(p, exc):
        class Boom(type(make_echo(p))):
            def __init__(self):
                super().__init__()
                self.halted = []

            async def receive(self, chan_id, peer, msg):
                raise exc

            def on_halt(self, e):
                self.halted.append(type(e).__name__)

        sw1, _, nk1 = await make_switch(p, 1, Boom())
        sw2, er2, nk2 = await make_switch(p, 2)
        peer = await sw2.dial_peer(f"{nk1.id}@{sw1.transport.listen_addr}",
                                   persistent=True)
        await until(lambda: sw1.n_peers() == 1, "inbound peer")
        await peer.send(0x77, b"anything")
        if p is PORT:
            with pytest.raises(KernelError):
                await sw1.wait_halted(timeout=10)
        else:
            await until(lambda: sw1.n_peers() == 0, "peer stopped")
        out = (sw1.is_running, sw1.reactors["echo"].halted,
               sw1._reconnect_tasks)
        if sw1.is_running:
            await sw1.stop()
        await sw2.stop()
        return out

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        (False, ["KernelError"], {})
    assert run(go(REF, RuntimeError("injected"))) == (True, [], {})
