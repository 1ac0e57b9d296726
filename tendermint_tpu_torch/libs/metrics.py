"""Prometheus-style metrics (reference: tendermint_tpu/libs/metrics.py;
Go libs and per-module metrics.go, docs/nodes/metrics.md:21-52).

Counters, gauges and histograms with optional labels, collected in a
process-global registry and rendered in the Prometheus text exposition
format. Served on the RPC listener at GET /metrics and (when
`instrumentation.prometheus` is on) on a dedicated listener
(libs/debugsrv.py).

Every family keeps the reference's metric names, labels and help
texts, subsystem `tpu` included, so that one scrape config reads both
packages; a label value that names a backend comes from
crypto/cuda/backend.py ("gpu", "cpu-fallback").

Hot paths record into plain floats under no lock (relaxed, like
Prometheus client libraries). The one consistency guarantee render()
makes: a histogram's cumulative buckets, `_count` and `+Inf` derive
from one snapshot of the bucket array, so concurrent observes (the
verify executor threads) never render `+Inf` != `_count`.

The tracing→metrics bridge at the bottom makes every span close
(libs/tracing.py) observe a histogram: the device-pipeline kinds
(crypto.pack/dispatch/device_exec/readback) feed the `tpu_*_seconds`
histograms, every other kind `tracing_span_seconds{kind=...}`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, fields as dc_fields

from . import tracing as _tracing


def _escape_label_value(v: str) -> str:
    """Exposition-format label-value escaping: backslash, double-quote
    and newline emitted raw produce unparseable output for values like
    peer addresses or chain ids (text format spec, label_value)."""
    return (str(v).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(h: str) -> str:
    """HELP lines escape backslash and newline (text format spec)."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    def __init__(self, name: str, help_: str, namespace: str = ""):
        self.name = f"{namespace}_{name}" if namespace else name
        self.namespace = namespace
        self.help = help_

    def render(self) -> list[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, namespace: str = ""):
        super().__init__(name, help_, namespace)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] = float(value)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Series:
    """One labelset's state: a bucket-count array and a running sum."""

    __slots__ = ("counts", "sum")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)
        self.sum = 0.0


class _BoundHistogram:
    """A histogram pre-resolved to one labelset: observe() is a bucket
    scan + two plain increments, no label handling per call — the
    handle the tracing bridge caches per span kind."""

    __slots__ = ("_buckets", "_series")

    def __init__(self, buckets: tuple, series: _Series):
        self._buckets = buckets
        self._series = series

    def observe(self, value: float) -> None:
        s = self._series
        s.sum += value
        for i, b in enumerate(self._buckets):
            if value <= b:
                s.counts[i] += 1
                return
        s.counts[-1] += 1


class Histogram(Metric):
    """Histogram with optional labels: `observe(v)` records into the
    unlabelled series, `observe(v, ch="0x20")` into a labelled one,
    `labels(ch="0x20")` returns a bound handle for hot paths."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, namespace: str = "",
                 buckets: tuple = _DEFAULT_BUCKETS):
        super().__init__(name, help_, namespace)
        self.buckets = tuple(sorted(buckets))
        self._series: dict[tuple, _Series] = {}
        self._series_lock = threading.Lock()

    def _series_for(self, key: tuple) -> _Series:
        s = self._series.get(key)
        if s is None:
            # creation is the only guarded op: a first-observe race
            # from two threads must not drop a whole series
            with self._series_lock:
                s = self._series.setdefault(
                    key, _Series(len(self.buckets)))
        return s

    def labels(self, **labels) -> _BoundHistogram:
        key = tuple(sorted(labels.items()))
        return _BoundHistogram(self.buckets, self._series_for(key))

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items())) if labels else ()
        s = self._series_for(key)
        s.sum += value
        for i, b in enumerate(self.buckets):
            if value <= b:
                s.counts[i] += 1
                return
        s.counts[-1] += 1

    @property
    def count(self) -> int:
        return sum(sum(s.counts) for s in self._series.values())

    @property
    def sum(self) -> float:
        return sum(s.sum for s in self._series.values())

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        series = sorted(self._series.items()) or [((), _Series(
            len(self.buckets)))]
        for key, s in series:
            # ONE snapshot of the bucket array per series: cumulative
            # buckets, +Inf and _count all derive from it, so a
            # concurrent observe (executor threads) can never render
            # +Inf != _count or a non-monotone cumulative sequence.
            counts = list(s.counts)
            lbl = dict(key)
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**lbl, 'le': _fmt_value(b)})} {cum}")
            cum += counts[-1]
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels({**lbl, 'le': '+Inf'})} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(lbl)} "
                       f"{_fmt_value(s.sum)}")
            out.append(f"{self.name}_count{_fmt_labels(lbl)} {cum}")
        return out

    class _Timer:
        def __init__(self, observe):
            self._observe = observe

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._observe(time.perf_counter() - self._t0)
            return False

    def time(self, **labels) -> "Histogram._Timer":
        if labels:
            return self._Timer(self.labels(**labels).observe)
        return self._Timer(self.observe)


class Registry:
    def __init__(self):
        self._metrics: list[Metric] = []
        self._lock = threading.Lock()

    def register(self, m: Metric) -> Metric:
        with self._lock:
            self._metrics.append(m)
        return m

    def counter(self, name, help_, namespace="") -> Counter:
        return self.register(Counter(name, help_, namespace))

    def gauge(self, name, help_, namespace="") -> Gauge:
        return self.register(Gauge(name, help_, namespace))

    def histogram(self, name, help_, namespace="",
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, namespace, buckets))

    def render_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# Process-global registry — the MetricsProvider analogue.
DEFAULT = Registry()


@dataclass
class ConsensusMetrics:
    """reference: consensus/metrics.go."""
    height: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "height", "Height of the chain.", "consensus"))
    rounds: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "rounds", "Round of the chain.", "consensus"))
    validators: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "validators", "Number of validators.", "consensus"))
    validators_power: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "validators_power", "Total voting power of validators.", "consensus"))
    missing_validators: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "missing_validators", "Validators absent from the last commit.",
        "consensus"))
    missing_validators_power: Gauge = field(
        default_factory=lambda: DEFAULT.gauge(
            "missing_validators_power",
            "Voting power of validators absent from the last commit.",
            "consensus"))
    byzantine_validators: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "byzantine_validators", "Validators that equivocated.", "consensus"))
    byzantine_validators_power: Gauge = field(
        default_factory=lambda: DEFAULT.gauge(
            "byzantine_validators_power",
            "Voting power of validators that equivocated.", "consensus"))
    validator_power: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "validator_power", "This node's voting power (0 if not a "
        "validator).", "consensus"))
    validator_last_signed_height: Gauge = field(
        default_factory=lambda: DEFAULT.gauge(
            "validator_last_signed_height",
            "Last height this node's precommit made a commit.",
            "consensus"))
    validator_missed_blocks: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "validator_missed_blocks",
            "Commits missing this node's precommit.", "consensus"))
    fast_syncing: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "fast_syncing", "1 while fast sync is running.", "consensus"))
    state_syncing: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "state_syncing", "1 while state sync is running.", "consensus"))
    num_txs: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "num_txs", "Transactions in the latest block.", "consensus"))
    block_size_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "block_size_bytes", "Size of the latest block.", "consensus"))
    total_txs: Counter = field(default_factory=lambda: DEFAULT.counter(
        "total_txs", "Total transactions committed.", "consensus"))
    block_interval_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "block_interval_seconds", "Time between blocks.", "consensus",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)))
    fast_sync_blocks: Counter = field(default_factory=lambda: DEFAULT.counter(
        "fast_sync_blocks", "Blocks applied via fast sync.", "consensus"))
    block_parts: Counter = field(default_factory=lambda: DEFAULT.counter(
        "block_parts", "Block parts received and added.", "consensus"))
    # --- TPU batch-verify observability (new capability; no reference
    # equivalent): these are the numbers that justify _DEVICE_THRESHOLD
    # and the micro-batch window empirically.
    vote_batch_size: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "vote_batch_size", "Votes per micro-batch.", "consensus",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)))
    vote_batch_wait_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "vote_batch_wait_seconds",
            "Window wait before a vote micro-batch verified.", "consensus"))


@dataclass
class CryptoMetrics:
    """Batch-verifier instrumentation (new; the SURVEY §6 speedup
    denominators come straight from these)."""
    batch_lanes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "batch_lanes_total", "Signature lanes verified, by backend.",
        "crypto"))
    batch_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "batch_verify_seconds", "Wall time per verify() call.",
            "crypto"))
    device_launches: Counter = field(default_factory=lambda: DEFAULT.counter(
        "device_launches_total", "Device kernel launches.", "crypto"))
    invalid_sigs: Counter = field(default_factory=lambda: DEFAULT.counter(
        "invalid_signatures_total", "Lanes that failed verification.",
        "crypto"))
    device_failures: Counter = field(default_factory=lambda: DEFAULT.counter(
        "device_failures_total",
        "Device batch launches that raised; host degradation engaged.",
        "crypto"))
    breaker_state: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "breaker_state",
        "Device circuit-breaker state by backend "
        "(0 closed, 1 open, 2 half-open).", "crypto"))
    breaker_opens: Counter = field(default_factory=lambda: DEFAULT.counter(
        "breaker_opens_total",
        "Circuit-breaker closed/half-open -> open transitions, "
        "by backend.", "crypto"))
    breaker_probes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "breaker_probes_total",
        "Half-open synthetic probe batches, by backend and result.",
        "crypto"))


@dataclass
class P2PMetrics:
    """reference: p2p/metrics.go."""
    peers: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "peers", "Connected peers.", "p2p"))
    peer_receive_bytes: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "peer_receive_bytes_total", "Bytes received, by channel.",
            "p2p"))
    peer_send_bytes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "peer_send_bytes_total", "Bytes sent, by channel.", "p2p"))
    pending_send_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "pending_send_bytes", "Pending bytes across peers.", "p2p"))
    message_receive: Counter = field(default_factory=lambda: DEFAULT.counter(
        "message_receive_total", "Complete messages received, by channel.",
        "p2p"))
    message_send: Counter = field(default_factory=lambda: DEFAULT.counter(
        "message_send_total", "Complete messages sent, by channel.", "p2p"))
    num_txs: Counter = field(default_factory=lambda: DEFAULT.counter(
        "num_txs", "Transactions received from peers.", "p2p"))
    reconnect_exhausted: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "reconnect_exhausted_total",
            "Persistent peers abandoned after exhausting reconnect "
            "attempts.", "p2p"))
    send_drops: Counter = field(default_factory=lambda: DEFAULT.counter(
        "send_drops_total",
        "Messages dropped on full send queues (try_send/broadcast), "
        "by channel.", "p2p"))
    slow_peer_events: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "slow_peer_events_total",
            "Slow-peer escalation transitions "
            "(skip/demote/disconnect/recover).", "p2p"))


@dataclass
class MempoolMetrics:
    """reference: mempool/metrics.go."""
    size: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "size", "Transactions in the mempool.", "mempool"))
    tx_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "tx_bytes", "Total bytes of transactions in the mempool.",
        "mempool"))
    tx_size_bytes: Histogram = field(default_factory=lambda: DEFAULT.histogram(
        "tx_size_bytes", "Transaction sizes.", "mempool",
        buckets=(32, 128, 512, 2048, 8192, 32768, 131072)))
    failed_txs: Counter = field(default_factory=lambda: DEFAULT.counter(
        "failed_txs", "CheckTx rejections.", "mempool"))
    recheck_times: Counter = field(default_factory=lambda: DEFAULT.counter(
        "recheck_times", "Transactions rechecked after commit.", "mempool"))


@dataclass
class AdmissionMetrics:
    """Device-offloaded tx admission plane (mempool/admission.py):
    the micro-batch collector in front of CheckTx. Occupancy and lane
    histograms show whether floods actually coalesce into wide device
    launches; the shed counter (by reason) is the evidence that junk
    dies at the device, not in the app."""
    batch_lanes: Histogram = field(default_factory=lambda: DEFAULT.histogram(
        "batch_lanes",
        "Txs per admission pre-verify flush (device or host).",
        "admission",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)))
    batch_occupancy: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "batch_occupancy_ratio",
            "Flush size / configured admission batch size.", "admission",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)))
    verify_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "verify_seconds",
            "Wall time of one admission batch-verify launch.",
            "admission"))
    admitted: Counter = field(default_factory=lambda: DEFAULT.counter(
        "admitted_total",
        "Txs past signature pre-verification, by signed=yes|no.",
        "admission"))
    sheds: Counter = field(default_factory=lambda: DEFAULT.counter(
        "shed_total",
        "Txs shed at admission before any ABCI round trip, by reason "
        "(bad_signature/malformed/unsigned/queue_full).", "admission"))
    launches: Counter = field(default_factory=lambda: DEFAULT.counter(
        "verify_launches_total",
        "Admission batch-verify launches, by backend "
        "(device/host/host_recheck).", "admission"))


@dataclass
class LightMetrics:
    """Light-client serving plane (light/serving.py): the shared
    verification plane between the proxy RPC surface and the light
    client. Lanes-per-launch and the coalesce/cache counters are the
    evidence that N concurrent client requests collapse into few wide
    device launches; the shed counter is the evidence a request flood
    dies at the plane, not in the event loop."""
    batch_lanes: Histogram = field(default_factory=lambda: DEFAULT.histogram(
        "batch_lanes",
        "Signature lanes per coalesced light-verify launch.", "light",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)))
    verify_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "verify_seconds",
            "Wall time of one coalesced light-verify launch.", "light"))
    verify_launches: Counter = field(default_factory=lambda: DEFAULT.counter(
        "verify_launches_total",
        "Light-plane batch-verify launches, by backend "
        "(device/host/host_recheck).", "light"))
    cache_hits: Counter = field(default_factory=lambda: DEFAULT.counter(
        "cache_hits_total",
        "Requests served from the verified-header cache.", "light"))
    cache_misses: Counter = field(default_factory=lambda: DEFAULT.counter(
        "cache_misses_total",
        "Requests that missed the verified-header cache.", "light"))
    requests_coalesced: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "requests_coalesced_total",
            "Requests that joined an in-flight verification for the "
            "same height instead of starting their own.", "light"))
    shed: Counter = field(default_factory=lambda: DEFAULT.counter(
        "shed_total",
        "Requests shed at the serving plane, by reason (queue_full).",
        "light"))


@dataclass
class SpeculationMetrics:
    """Verify-ahead pipeline (consensus/speculation.py +
    crypto/tpu/resident.py): commit verification launched BEFORE the
    commit is needed, served at commit time from a byte-exact template
    match. The hit counter is the evidence the commit-time verify
    vanished from the critical path; overlap_seconds is how far ahead
    the launch completed; arena/reupload bytes quantify what device
    residency + donated buffers save per launch."""
    hits: Counter = field(default_factory=lambda: DEFAULT.counter(
        "hits_total",
        "Commits whose verdicts were fully served from a completed "
        "speculative launch (zero verification launches on the "
        "post-commit critical path).", "speculation"))
    misses: Counter = field(default_factory=lambda: DEFAULT.counter(
        "misses_total",
        "Speculation misses, by reason (no_plan once per unserved "
        "commit; unpatched/mismatch/equivocation/not_launched per "
        "fallback lane).", "speculation"))
    patched_lanes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "patched_lanes_total",
        "Precommit lanes patched into the speculative batch as votes "
        "arrived.", "speculation"))
    launches: Counter = field(default_factory=lambda: DEFAULT.counter(
        "launches_total",
        "Speculative verification launches, by backend "
        "(device/host/host_recheck).", "speculation"))
    overlap_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "overlap_seconds",
            "Time between a speculative launch completing and its "
            "verdicts being served at commit time.", "speculation"))
    arena_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "arena_bytes",
        "Bytes of persistent device-resident verify buffers "
        "(crypto/tpu/resident.py ResidentArena).", "speculation"))
    reupload_bytes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "resident_reupload_bytes_total",
        "Host-to-device bytes actually shipped by arena delta splices "
        "and per-launch templates (vs re-transferring every lane).",
        "speculation"))


@dataclass
class BlockchainMetrics:
    """Fast-sync pool instrumentation (reference has no blocksync
    metrics in v0.34; names follow the pool's own vocabulary)."""
    pool_height: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "pool_height", "Next height the fast-sync pool will fetch.",
        "blockchain"))
    pending_requests: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "pending_requests", "In-flight block requests.", "blockchain"))
    num_peers: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "num_peers", "Peers the fast-sync pool can fetch from.",
        "blockchain"))
    blocks_synced: Counter = field(default_factory=lambda: DEFAULT.counter(
        "blocks_synced_total", "Blocks verified and applied by fast sync.",
        "blockchain"))
    block_bytes_received: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "block_bytes_received_total",
            "Block-response bytes received from peers.", "blockchain"))


@dataclass
class StateSyncMetrics:
    """Snapshot-restore instrumentation (reference: statesync/)."""
    syncing: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "syncing", "1 while state sync is running.", "statesync"))
    snapshots_discovered: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "snapshots_discovered_total",
            "Snapshot advertisements received from peers.", "statesync"))
    chunks_received: Counter = field(default_factory=lambda: DEFAULT.counter(
        "chunks_received_total", "Snapshot chunks received.", "statesync"))
    chunks_served: Counter = field(default_factory=lambda: DEFAULT.counter(
        "chunks_served_total", "Snapshot chunks served to peers.",
        "statesync"))
    chunk_retries: Counter = field(default_factory=lambda: DEFAULT.counter(
        "chunk_retries_total",
        "Snapshot chunk fetches re-requested after a miss/timeout.",
        "statesync"))
    chunks_refetched: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "chunks_refetched_total",
            "Snapshot chunks discarded and re-fetched, by reason "
            "(poisoned restore attempt, app refetch/retry verdicts).",
            "statesync"))
    peers_quarantined: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "peers_quarantined_total",
            "Snapshot peers quarantined for serving provably bad "
            "chunks or app-rejected senders.", "statesync"))
    restore_attempts: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "restore_attempts_total",
            "Snapshot restore attempts started (first try plus every "
            "re-fetch with a rotated peer mix).", "statesync"))


@dataclass
class EvidenceMetrics:
    """reference: evidence/metrics.go (pool size) + admission counters."""
    pool_size: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "pool_size", "Pending evidence in the pool.", "evidence"))
    pool_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "pool_bytes", "Bytes of pending evidence in the pool.", "evidence"))
    verified: Counter = field(default_factory=lambda: DEFAULT.counter(
        "verified_total", "Evidence verified and admitted to the pool.",
        "evidence"))
    committed: Counter = field(default_factory=lambda: DEFAULT.counter(
        "committed_total", "Evidence committed in blocks.", "evidence"))


@dataclass
class StateMetrics:
    """reference: state/metrics.go."""
    block_processing_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "block_processing_seconds", "ApplyBlock wall time.", "state"))
    commit_verify_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "commit_verify_seconds",
            "LastCommit signature-batch wall time.", "state"))
    validator_set_updates: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "validator_set_updates_total",
            "Validator updates applied from EndBlock.", "state"))
    consensus_param_updates: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "consensus_param_updates_total",
            "Consensus-parameter updates applied from EndBlock.", "state"))


@dataclass
class ABCIMetrics:
    """Per-method ABCI connection latency (reference: the per-method
    `abci_connection_method_timing_seconds` added in later lines)."""
    method_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "connection_method_seconds",
            "ABCI call latency, by connection and method.", "abci"))
    client_reconnects: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "client_reconnects_total",
            "ABCI client transport reconnect attempts, by result.",
            "abci"))


@dataclass
class TPUMetrics:
    """Device verify-pipeline telemetry (new capability; no reference
    equivalent). The four stage histograms are fed by the
    tracing→metrics bridge from existing span closes — no extra
    instrumentation sites in the hot path."""
    verify_queue_depth: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "verify_queue_depth",
        "Votes waiting in the micro-batch verify queue.", "tpu"))
    batch_occupancy: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "batch_occupancy_ratio",
            "Real lanes / padded bucket size per device batch.", "tpu",
            buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                     0.9, 1.0)))
    pack_seconds: Histogram = field(default_factory=lambda: DEFAULT.histogram(
        "pack_seconds", "Host byte-packing time per launch "
        "(bridge-fed from crypto.pack spans).", "tpu"))
    dispatch_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "dispatch_seconds", "Kernel-launch enqueue time "
            "(bridge-fed from crypto.dispatch spans).", "tpu"))
    device_exec_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "device_exec_seconds", "Wait-until-verdicts-ready time "
            "(bridge-fed from crypto.device_exec spans).", "tpu"))
    readback_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "readback_seconds", "Device-to-host verdict copy time "
            "(bridge-fed from crypto.readback spans).", "tpu"))
    host_fallbacks: Counter = field(default_factory=lambda: DEFAULT.counter(
        "host_fallbacks_total",
        "Batches that wanted the device but verified on host.", "tpu"))
    batch_splits: Counter = field(default_factory=lambda: DEFAULT.counter(
        "batch_splits_total",
        "Verifies split into multiple launches (batch > max bucket).",
        "tpu"))
    jit_compiles: Counter = field(default_factory=lambda: DEFAULT.counter(
        "jit_compiles_total",
        "First launches at a new kernel shape (each triggers an XLA "
        "trace+compile), by kernel.", "tpu"))
    expanded_cache: Counter = field(default_factory=lambda: DEFAULT.counter(
        "expanded_cache_events_total",
        "Expanded-valset table cache hits/misses.", "tpu"))
    expanded_build_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "expanded_build_seconds",
            "Wall time building expanded comb tables for a valset.", "tpu",
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120)))
    mesh_devices: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "mesh_devices",
        "Devices in the ('dp',) verify mesh (1 = single-device).",
        "tpu"))
    shard_lanes: Counter = field(default_factory=lambda: DEFAULT.counter(
        "shard_lanes_total",
        "Signature lanes dispatched to each mesh device by sharded "
        "verify launches, by device.", "tpu"))
    table_shard_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "table_shard_bytes",
        "Per-device bytes of the newest key-range-sharded expanded "
        "comb table (0 until a sharded build runs).", "tpu"))
    effective_backend: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "effective_backend",
        "One-hot effective verify backend classified from the launch "
        "ledger by the silicon watchdog, by backend state.", "tpu"))
    launch_ledger_records: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "launch_ledger_records_total",
            "Device launch-ledger records appended, by workload and "
            "backend.", "tpu"))
    launch_ledger_evictions: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "launch_ledger_evictions_total",
            "Launch-ledger records evicted from the bounded ring.",
            "tpu"))
    hbm_resident_bytes: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "hbm_resident_bytes",
        "Device-resident bytes registered with the HBM accounting "
        "registry, by device and kind.", "tpu"))
    device_breaker_state: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "device_breaker_state",
        "Per-mesh-device circuit-breaker state (0 closed, 1 open, "
        "2 half-open), by device.", "tpu"))
    mesh_evictions: Counter = field(default_factory=lambda: DEFAULT.counter(
        "mesh_evictions_total",
        "Mesh devices evicted from the verify fabric (per-device "
        "breaker opened), by device and reason.", "tpu"))
    reshard_seconds: Histogram = field(
        default_factory=lambda: DEFAULT.histogram(
            "reshard_seconds",
            "Wall time of a live fabric reshard (rebuilding key-range "
            "shards / resident arena over the surviving device set).",
            "tpu",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)))
    mesh_active_devices: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "mesh_active_devices",
        "Devices currently serving the verify mesh (mesh size minus "
        "evicted devices; 0 until a mesh forms).", "tpu"))


@dataclass
class FailpointMetrics:
    """Chaos-injection blast radius (libs/failpoints.py): how often
    each armed point was evaluated and how often it actually fired —
    on the same scrape as the degradation it causes."""
    hits: Counter = field(default_factory=lambda: DEFAULT.counter(
        "hits_total",
        "Armed failpoint evaluations, by point.", "failpoint"))
    fires: Counter = field(default_factory=lambda: DEFAULT.counter(
        "fires_total",
        "Failpoint actions actually injected, by point and action.",
        "failpoint"))


@dataclass
class RecoveryMetrics:
    """Startup reconciliation (consensus/replay.py): every legal
    cross-store skew a crash can leave is enumerated and healed on
    boot, and each heal is counted here — a fleet whose repair
    counters climb without chaos injections has a disk/crash problem
    worth paging on."""
    repairs: Counter = field(default_factory=lambda: DEFAULT.counter(
        "repairs_total",
        "Cross-store skews healed by the startup reconciler, by "
        "repair kind.", "recovery"))
    blocks_replayed: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "blocks_replayed_total",
            "Blocks replayed into the app or re-applied to state "
            "during startup reconciliation.", "recovery"))
    quarantined_files: Gauge = field(
        default_factory=lambda: DEFAULT.gauge(
            "quarantined_files",
            "Corruption-evidence files (*.corrupt.NNN) present in the "
            "data/WAL dirs at the last startup scan.", "recovery"))


@dataclass
class RPCMetrics:
    """JSON-RPC server overload surface (this framework's addition):
    the 429-style limiter and the bounded websocket event queue."""
    ws_events_dropped: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "ws_events_dropped_total",
            "Websocket events dropped (drop-oldest) from the bounded "
            "client notification queue.", "rpc"))
    requests_rejected: Counter = field(
        default_factory=lambda: DEFAULT.counter(
            "requests_rejected_total",
            "JSON-RPC requests rejected by the overload limiter "
            "(429-style), by reason.", "rpc"))
    requests_in_flight: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "requests_in_flight",
        "JSON-RPC requests currently being handled.", "rpc"))


@dataclass
class OverloadMetrics:
    """The overload controller's aggregate view (libs/overload.py):
    one level gauge plus per-tracked-queue depth/capacity/shed — the
    numbers the liveness-under-overload e2e asserts on."""
    level: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "level",
        "Aggregate overload level (0 ok, 1 pressured, 2 shedding).",
        "overload"))
    queue_depth: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "queue_depth",
        "Current depth of each tracked bounded queue.", "overload"))
    queue_capacity: Gauge = field(default_factory=lambda: DEFAULT.gauge(
        "queue_capacity",
        "Configured bound of each tracked queue.", "overload"))
    shed: Counter = field(default_factory=lambda: DEFAULT.counter(
        "shed_total",
        "Items dropped by shedding policy, by tracked queue.",
        "overload"))


@dataclass
class TracingMetrics:
    """The generic half of the tracing→metrics bridge: span kinds with
    no dedicated histogram land here, labelled by kind."""
    span_seconds: Histogram = field(default_factory=lambda: DEFAULT.histogram(
        "span_seconds", "Span duration by registered kind "
        "(bridge-fed from every span close).", "tracing"))
    spans_dropped: Counter = field(default_factory=lambda: DEFAULT.counter(
        "spans_dropped_total",
        "Spans evicted from the trace ring buffer (overflow) — "
        "non-zero means /debug/trace is a suffix of the timeline, "
        "not the whole of it.", "tracing"))


_SINGLETONS: dict[str, object] = {}
_SINGLETONS_LOCK = threading.Lock()


def _singleton(key: str, cls):
    # NOT setdefault(key, cls()): constructing the dataclass registers
    # its metrics into DEFAULT, so the constructor must only ever run
    # once per key — and under a lock, because these accessors are
    # called from executor threads (BatchVerifier offload) as well as
    # the event loop; a first-call race would double-register a whole
    # metric family and corrupt the exposition output.
    with _SINGLETONS_LOCK:
        if key not in _SINGLETONS:
            _SINGLETONS[key] = cls()
        return _SINGLETONS[key]


def consensus_metrics() -> ConsensusMetrics:
    return _singleton("consensus", ConsensusMetrics)


def crypto_metrics() -> CryptoMetrics:
    return _singleton("crypto", CryptoMetrics)


def p2p_metrics() -> P2PMetrics:
    return _singleton("p2p", P2PMetrics)


def mempool_metrics() -> MempoolMetrics:
    return _singleton("mempool", MempoolMetrics)


def admission_metrics() -> AdmissionMetrics:
    return _singleton("admission", AdmissionMetrics)


def light_metrics() -> LightMetrics:
    return _singleton("light", LightMetrics)


def speculation_metrics() -> SpeculationMetrics:
    return _singleton("speculation", SpeculationMetrics)


def blockchain_metrics() -> BlockchainMetrics:
    return _singleton("blockchain", BlockchainMetrics)


def statesync_metrics() -> StateSyncMetrics:
    return _singleton("statesync", StateSyncMetrics)


def evidence_metrics() -> EvidenceMetrics:
    return _singleton("evidence", EvidenceMetrics)


def state_metrics() -> StateMetrics:
    return _singleton("state", StateMetrics)


def abci_metrics() -> ABCIMetrics:
    return _singleton("abci", ABCIMetrics)


def tpu_metrics() -> TPUMetrics:
    return _singleton("tpu", TPUMetrics)


def tracing_metrics() -> TracingMetrics:
    return _singleton("tracing", TracingMetrics)


def failpoint_metrics() -> FailpointMetrics:
    return _singleton("failpoint", FailpointMetrics)


def rpc_metrics() -> RPCMetrics:
    return _singleton("rpc", RPCMetrics)


def overload_metrics() -> OverloadMetrics:
    return _singleton("overload", OverloadMetrics)


def recovery_metrics() -> RecoveryMetrics:
    return _singleton("recovery", RecoveryMetrics)


# ------------------------------------------------- MetricsProvider wiring

@dataclass
class NodeMetrics:
    """The full per-module bundle one node records into — what the
    reference's MetricsProvider returns per subsystem
    (node/node.go:110-125), collapsed into one object because our
    modules share process-global singletons."""

    consensus: ConsensusMetrics
    crypto: CryptoMetrics
    p2p: P2PMetrics
    mempool: MempoolMetrics
    admission: AdmissionMetrics
    light: LightMetrics
    speculation: SpeculationMetrics
    blockchain: BlockchainMetrics
    statesync: StateSyncMetrics
    evidence: EvidenceMetrics
    state: StateMetrics
    abci: ABCIMetrics
    tpu: TPUMetrics
    tracing: TracingMetrics
    failpoint: FailpointMetrics
    rpc: RPCMetrics
    overload: OverloadMetrics
    recovery: RecoveryMetrics


def node_metrics() -> NodeMetrics:
    """Materialize every per-module metric family (idempotent). A
    scrape of a freshly-started node must show the full catalog, not
    just the families something has already recorded into."""
    return NodeMetrics(
        consensus=consensus_metrics(), crypto=crypto_metrics(),
        p2p=p2p_metrics(), mempool=mempool_metrics(),
        admission=admission_metrics(), light=light_metrics(),
        speculation=speculation_metrics(),
        blockchain=blockchain_metrics(), statesync=statesync_metrics(),
        evidence=evidence_metrics(), state=state_metrics(),
        abci=abci_metrics(), tpu=tpu_metrics(),
        tracing=tracing_metrics(), failpoint=failpoint_metrics(),
        rpc=rpc_metrics(), overload=overload_metrics(),
        recovery=recovery_metrics(),
    )


def metrics_provider(instrumentation):
    """reference: node/node.go:110-125 DefaultMetricsProvider — with
    `instrumentation.prometheus` on, the node eagerly constructs every
    subsystem's metric family at build time (so the first scrape is
    complete); off, modules keep lazily materializing only what they
    record into, the Nop analogue."""
    def provider(chain_id: str) -> NodeMetrics | None:
        if instrumentation.prometheus:
            return node_metrics()
        return None

    return provider


def all_module_metrics() -> dict[str, Metric]:
    """{metric_name: Metric} over every dataclass field of the full
    bundle — the declared catalog."""
    out: dict[str, Metric] = {}
    nm = node_metrics()
    for module_field in dc_fields(nm):
        bundle = getattr(nm, module_field.name)
        for f in dc_fields(bundle):
            m = getattr(bundle, f.name)
            out[m.name] = m
    return out


# ------------------------------------------------ snapshot / delta

def snapshot(registry: Registry | None = None) -> dict:
    """Point-in-time copy of every metric's values, keyed by
    `name{labels}`. Counters/gauges map to floats; histograms to
    {"buckets": (...), "counts": [...], "sum": s}. Input to delta()."""
    reg = registry or DEFAULT
    with reg._lock:
        metrics = list(reg._metrics)
    out: dict = {}
    for m in metrics:
        if isinstance(m, Histogram):
            for key, s in list(m._series.items()):
                out[m.name + _fmt_labels(dict(key))] = {
                    "buckets": m.buckets,
                    "counts": list(s.counts),
                    "sum": s.sum,
                }
        else:
            for key, v in list(m._values.items()):
                out[m.name + _fmt_labels(dict(key))] = v
    return out


def _bucket_quantile(buckets, counts, q: float):
    """Prometheus-style histogram_quantile over one bucket-count
    vector: linear interpolation inside the bucket; the overflow
    bucket clamps to the largest finite bound."""
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            frac = (rank - prev) / counts[i] if counts[i] else 0.0
            return lo + (b - lo) * frac
        lo = b
    return buckets[-1]


def delta(before: dict, after: dict) -> dict:
    """What changed between two snapshot()s: counter/gauge increments
    (nonzero only) and, per histogram series with new observations,
    the count/sum delta plus p50/p95/p99 estimated from the bucket
    deltas."""
    out: dict = {}
    for key, val in after.items():
        prev = before.get(key)
        if isinstance(val, dict):
            pcounts = prev["counts"] if isinstance(prev, dict) \
                else [0] * len(val["counts"])
            dcounts = [a - b for a, b in zip(val["counts"], pcounts)]
            n = sum(dcounts)
            if n <= 0:
                continue
            psum = prev["sum"] if isinstance(prev, dict) else 0.0
            finite = val["buckets"]
            out[key] = {
                "count": n,
                "sum": round(val["sum"] - psum, 6),
                "p50": _bucket_quantile(finite, dcounts, 0.50),
                "p95": _bucket_quantile(finite, dcounts, 0.95),
                "p99": _bucket_quantile(finite, dcounts, 0.99),
            }
        else:
            d = val - (prev if isinstance(prev, float) else 0.0)
            if d != 0:
                out[key] = round(d, 6)
    return out


# ------------------------------------------------ tracing→metrics bridge

# Span kinds with a dedicated histogram; resolved lazily so importing
# this module does not force-construct the tpu family.
_BRIDGE_DEDICATED = {
    _tracing.CRYPTO_PACK: lambda: tpu_metrics().pack_seconds,
    _tracing.CRYPTO_DISPATCH: lambda: tpu_metrics().dispatch_seconds,
    _tracing.CRYPTO_DEVICE_EXEC: lambda: tpu_metrics().device_exec_seconds,
    _tracing.CRYPTO_READBACK: lambda: tpu_metrics().readback_seconds,
}
_BRIDGE_CACHE: dict[str, object] = {}


def span_metrics_sink(kind: str, seconds: float) -> None:
    """Installed into the global TRACER: every span close observes one
    histogram — the dedicated tpu stage histogram for the device
    pipeline kinds, tracing_span_seconds{kind=...} for the rest. The
    per-close cost is one dict lookup + one bucket scan (the bound
    handle is cached per kind)."""
    ob = _BRIDGE_CACHE.get(kind)
    if ob is None:
        mk = _BRIDGE_DEDICATED.get(kind)
        if mk is not None:
            h = mk()
            ob = _BoundHistogram(h.buckets, h._series_for(()))
        else:
            ob = tracing_metrics().span_seconds.labels(kind=kind)
        _BRIDGE_CACHE[kind] = ob
    ob.observe(seconds)


def span_drop_sink(n: int) -> None:
    """Installed into the global TRACER: counts ring-buffer evictions
    so a truncated trace export is detectable from /metrics alone."""
    tracing_metrics().spans_dropped.inc(n)


# One instrumentation point, two exports: the ring buffer keeps the
# per-event timeline, the sink keeps the aggregate histograms.
_tracing.TRACER.set_metrics_sink(span_metrics_sink)
_tracing.TRACER.set_drop_sink(span_drop_sink)
