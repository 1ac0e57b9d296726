"""Multiplexed connection (reference: p2p/conn/connection.py; Go
p2p/conn/connection.go:78).

One secret connection carries N logical channels. Messages are cut
into packets (channel id, eof flag, fragment) so a large block part
can't head-of-line-block a vote; the send loop picks the channel with
the lowest sent-bytes/priority ratio (reference sendPacketMsg's
least-ratio selection). Ping/pong keepalive with a pong timeout, and
token-bucket send/recv rate limiting (reference: flowrate.Monitor,
default 500 KB/s each way).

The reference's p2p metric families are kept in ``METRICS``, a plain
dict (the convention of crypto/batch.py METRICS): counters by channel
(``"0x20"``) and the process-wide unsent backlog. The reference's
``p2p.send_flush`` and ``p2p.recv_msg`` spans wait for the port's
tracing.

The port's rule for its own faults (crypto/batch.py UNCAUGHT): a
KernelError or NoDeviceError raised by ``on_receive`` (a reactor's
receive, reached through the Switch) is not turned into a connection
error that only drops the peer: the receive routine hands it to
``on_fault`` (the Switch halts the node) and ends. The reference's
``_recv_routine`` turns every exception into ``on_error``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ...crypto.batch import UNCAUGHT
from ...libs import clock, failpoints, flowrate
from ...libs.overload import CONTROLLER
from ...libs.service import Service
from .secret_connection import DATA_MAX, SEALED_SIZE, SecretConnection

# packet types
_PKT_PING = 0x01
_PKT_PONG = 0x02
_PKT_MSG = 0x03

MAX_PACKET_PAYLOAD = DATA_MAX - 8  # header: type+chan+eof+len(2) < 8

# The reference's p2p metric families (libs/metrics.py p2p_metrics), as
# plain values: "peers" and "pending_send_bytes" are gauges, the dicts
# count by channel ("0x20") or by slow-peer action.
METRICS: dict = {
    "peers": 0,
    "pending_send_bytes": 0,
    "peer_send_bytes": {},
    "peer_receive_bytes": {},
    "message_send": {},
    "message_receive": {},
    "send_drops": {},
    "num_txs": 0,
    "slow_peer_events": {},
    "reconnect_exhausted": 0,
}


def count(family: str, key: str, n: int = 1) -> None:
    """Add `n` to a by-label counter of METRICS."""
    d = METRICS[family]
    d[key] = d.get(key, 0) + n


@dataclass
class ChannelDescriptor:
    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 22020096  # ~21MB, reference consensus default
    name: str = ""


@dataclass
class MConnConfig:
    """reference: MConnConfig (connection.go:122)."""

    send_rate: int = 5_000_000       # bytes/s (reference default 500KB/s;
    recv_rate: int = 5_000_000       # raised: today's NICs are not 2014's)
    flush_throttle_ms: int = 10
    ping_interval_s: float = 10.0
    pong_timeout_s: float = 45.0
    max_packet_payload: int = MAX_PACKET_PAYLOAD


@dataclass
class ChannelStatus:
    id: int
    send_queue_size: int
    priority: int
    recently_sent: int
    send_rate: float = 0.0   # flowrate EWMA bytes/s
    recv_rate: float = 0.0


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.label = f"{desc.id:#04x}"
        self.queue: asyncio.Queue[bytes] = asyncio.Queue(
            desc.send_queue_capacity)
        self.sending: bytes | None = None   # message being packetized
        self.sent_pos = 0
        self.recently_sent = 0
        self.recv_buf = bytearray()
        # bytes accepted by send()/try_send() but not yet fully
        # packetized — feeds the p2p_pending_send_bytes gauge
        self.pending_bytes = 0
        # per-channel EWMA byte-rate monitors (reference: each
        # MConnection carries flowrate monitors; exposed via status())
        self.send_monitor = flowrate.Monitor()
        self.recv_monitor = flowrate.Monitor()

    def load_next(self) -> bool:
        if self.sending is None and not self.queue.empty():
            self.sending = self.queue.get_nowait()
            self.sent_pos = 0
        return self.sending is not None

    def next_packet(self, max_payload: int) -> tuple[bytes, bool]:
        assert self.sending is not None
        frag = self.sending[self.sent_pos:self.sent_pos + max_payload]
        self.sent_pos += len(frag)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            # gauge dec happens HERE, in lockstep with pending_bytes:
            # decrementing later (after the write) would leak the
            # message into the gauge forever if the conn dies between
            # the final fragment being pulled and the write finishing
            self.pending_bytes -= len(self.sending)
            METRICS["pending_send_bytes"] -= len(self.sending)
            self.sending = None
            self.sent_pos = 0
        return frag, eof


class _TokenBucket:
    def __init__(self, rate: int):
        self.rate = rate
        self.tokens = float(rate)
        self.last = clock.monotonic()

    async def consume(self, n: int) -> None:
        while True:
            now = clock.monotonic()
            self.tokens = min(self.rate, self.tokens + (now - self.last) * self.rate)
            self.last = now
            if self.tokens >= n:
                self.tokens -= n
                return
            # 1ms floor: the exact deficit can round to a sleep whose
            # wake-up advances the clock by LESS than the deficit
            # (float truncation), which under a virtual clock spins
            # forever refilling ~0 tokens per iteration
            await asyncio.sleep(max((n - self.tokens) / self.rate, 1e-3))


class MConnection(Service):
    """on_receive(chan_id, msg_bytes) runs on the recv loop; on_error(exc)
    fires once when either loop dies (the Switch stops the peer);
    on_fault(exc) takes a port fault (UNCAUGHT) from on_receive instead
    (the Switch halts the node)."""

    def __init__(self, conn: SecretConnection,
                 channels: list[ChannelDescriptor],
                 on_receive, on_error=None, config: MConnConfig | None = None,
                 on_fault=None):
        super().__init__(name="MConnection")
        self.conn = conn
        self.config = config or MConnConfig()
        self.channels = {d.id: _Channel(d) for d in channels}
        self.on_receive = on_receive
        self.on_error = on_error
        self.on_fault = on_fault
        self._send_signal = asyncio.Event()
        self._pong_pending = asyncio.Event()
        self._closed = asyncio.Event()
        self._send_bucket = _TokenBucket(self.config.send_rate)
        self._recv_bucket = _TokenBucket(self.config.recv_rate)
        self._errored = False

    async def on_start(self) -> None:
        self.spawn(self._send_routine(), "mconn-send")
        self.spawn(self._recv_routine(), "mconn-recv")
        self.spawn(self._ping_routine(), "mconn-ping")

    async def on_stop(self) -> None:
        self._closed.set()
        self.conn.close()
        # messages that will never finish sending must not inflate the
        # process-wide pending gauge forever
        for ch in self.channels.values():
            if ch.pending_bytes:
                METRICS["pending_send_bytes"] -= ch.pending_bytes
                ch.pending_bytes = 0

    def _error(self, exc: Exception) -> None:
        if self._errored:
            return
        self._errored = True
        self._closed.set()
        if self.on_error is not None:
            self.on_error(exc)

    # -- sending --

    async def send(self, chan_id: int, msg: bytes) -> bool:
        """Queue a message; awaits if the channel queue is full
        (reference Peer.Send blocking semantics). The wait is raced
        against connection death — a full queue on a dead conn would
        otherwise strand the caller forever."""
        ch = self.channels.get(chan_id)
        if ch is None or not self.is_running:
            return False
        put = asyncio.ensure_future(ch.queue.put(msg))
        closed = asyncio.ensure_future(self._closed.wait())
        try:
            done, _ = await asyncio.wait(
                {put, closed}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for f in (put, closed):
                if not f.done():
                    f.cancel()
        if put not in done or put.cancelled():
            return False
        ch.pending_bytes += len(msg)
        METRICS["pending_send_bytes"] += len(msg)
        self._send_signal.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send; False if the queue is full. Drops are
        counted (METRICS["send_drops"] and the overload controller's
        shed signal): a broadcast quietly losing messages to a full
        channel is the saturation evidence an operator needs."""
        ch = self.channels.get(chan_id)
        if ch is None or not self.is_running:
            return False
        try:
            ch.queue.put_nowait(msg)
        except asyncio.QueueFull:
            count("send_drops", ch.label)
            CONTROLLER.shed("p2p.send")
            return False
        ch.pending_bytes += len(msg)
        METRICS["pending_send_bytes"] += len(msg)
        self._send_signal.set()
        return True

    def pending_send_bytes(self) -> int:
        """Unsent backlog across channels — the slow-peer monitor's
        high-water signal (reference: ConnectionStatus SendQueueSize;
        ours is byte-accurate from the per-channel pending counters)."""
        return sum(ch.pending_bytes for ch in self.channels.values())

    def send_rate(self) -> float:
        """Aggregate EWMA send rate (bytes/s) across channels, from
        the existing flowrate monitors."""
        return sum(ch.send_monitor.rate for ch in self.channels.values())

    def _pick_channel(self) -> _Channel | None:
        """Least recently_sent/priority ratio among channels with data
        (reference: sendPacketMsg)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.load_next():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    async def _send_routine(self) -> None:
        try:
            throttle = self.config.flush_throttle_ms / 1000.0
            last_flush = clock.monotonic()
            while True:
                ch = self._pick_channel()
                if ch is None:
                    # flush whatever is buffered before going idle
                    await self.conn.drain()
                    self._send_signal.clear()
                    # decay recently_sent while idle (reference: 2x/s)
                    for c in self.channels.values():
                        c.recently_sent = int(c.recently_sent * 0.8)
                    await self._send_signal.wait()
                    continue
                frag, eof = ch.next_packet(self.config.max_packet_payload)
                pkt = bytes([_PKT_MSG, ch.desc.id, 1 if eof else 0]) + \
                    len(frag).to_bytes(2, "big") + frag
                await self._send_bucket.consume(len(pkt))
                # chaos: `corrupt` garbles the plaintext packet (the
                # peer must detect and drop us); `error` kills the
                # send routine like a socket failure would; `delay`
                # (async) stalls this peer's sends, not the whole loop
                pkt = await failpoints.hit_async("p2p.send", payload=pkt)
                self.conn.write_frame(pkt)
                ch.recently_sent += len(pkt)
                ch.send_monitor.update(len(pkt))
                count("peer_send_bytes", ch.label, len(pkt))
                if eof:
                    count("message_send", ch.label)
                # Throttled flush (reference flushThrottle): draining per
                # 1KB packet would serialize a block part into ~1000
                # scheduler round-trips; drain only every flush interval,
                # plus once when the queues run dry above.
                now = clock.monotonic()
                if now - last_flush >= throttle:
                    await self.conn.drain()
                    last_flush = now
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._error(e)

    # -- receiving --

    async def _recv_routine(self) -> None:
        try:
            while True:
                pkt = await self.conn.read_frame()
                # charge wire bytes (sealed frame), not payload — else
                # tiny-payload frames bypass the limiter entirely
                await self._recv_bucket.consume(SEALED_SIZE)
                if not pkt:
                    continue
                t = pkt[0]
                if t == _PKT_PING:
                    self.conn.write_frame(bytes([_PKT_PONG]))
                    await self.conn.drain()
                elif t == _PKT_PONG:
                    self._pong_pending.set()
                elif t == _PKT_MSG:
                    chan_id, eof = pkt[1], pkt[2]
                    ln = int.from_bytes(pkt[3:5], "big")
                    ch = self.channels.get(chan_id)
                    if ch is None:
                        raise ValueError(f"unknown channel {chan_id:#x}")
                    ch.recv_monitor.update(len(pkt))
                    count("peer_receive_bytes", ch.label, len(pkt))
                    ch.recv_buf += pkt[5:5 + ln]
                    if len(ch.recv_buf) > ch.desc.recv_message_capacity:
                        raise ValueError(
                            f"recv msg exceeds capacity on {chan_id:#x}")
                    if eof:
                        msg = bytes(ch.recv_buf)
                        ch.recv_buf = bytearray()
                        count("message_receive", ch.label)
                        res = self.on_receive(chan_id, msg)
                        if asyncio.iscoroutine(res):
                            await res
                else:
                    raise ValueError(f"unknown packet type {t}")
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            # the port's own fault: the node halts, the peer is not
            # blamed (the reference's routine reports it via on_error)
            if self.on_fault is None:
                raise
            self._closed.set()
            self.on_fault(e)
        except Exception as e:
            self._error(e)

    async def _ping_routine(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.config.ping_interval_s)
                self._pong_pending.clear()
                self.conn.write_frame(bytes([_PKT_PING]))
                await self.conn.drain()
                try:
                    await asyncio.wait_for(self._pong_pending.wait(),
                                           self.config.pong_timeout_s)
                except asyncio.TimeoutError:
                    raise TimeoutError("pong timeout") from None
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._error(e)

    def status(self) -> list[ChannelStatus]:
        return [
            ChannelStatus(ch.desc.id, ch.queue.qsize(), ch.desc.priority,
                          ch.recently_sent,
                          send_rate=ch.send_monitor.rate,
                          recv_rate=ch.recv_monitor.rate)
            for ch in self.channels.values()
        ]
