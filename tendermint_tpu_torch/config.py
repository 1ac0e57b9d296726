"""Node configuration (reference: config.py; Go config/config.go:55-68).

One Config of per-module sections with validate_basic on each, saved
and loaded in the reference's file format (a flat key = value list per
[section]): a file either package saves loads in the other to an equal
config. The [crypto] section configures the launch ledger and the
watchdog (crypto/cuda/ledger.py, watchdog.py), [instrumentation] the
Prometheus listener (libs/debugsrv.py)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class BaseConfig:
    """reference: config.py:15 BaseConfig: the data directory, the KV
    backend and its durability, the key files, the remote signer's
    address, the ABCI transport and app, and the peer filter."""

    chain_id: str = ""
    moniker: str = "node"
    home: str = "."
    fast_sync: bool = True
    db_dir: str = "data"
    # sqlite (ordered, disk-resident, range deletes — the tm-db
    # analogue) | filedb (log-structured, memory-resident) | memdb
    db_backend: str = "sqlite"
    # sqlite durability (PRAGMA synchronous): FULL fsyncs every
    # committed batch — the contract crash recovery relies on.
    # NORMAL/OFF trade the tail of the log for write speed; only safe
    # for replayable non-validator workloads (libs/db.py SqliteDB).
    db_synchronous: str = "FULL"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # When set (e.g. "tcp://127.0.0.1:26659"), the node LISTENS here
    # for a remote signer to dial in and uses it instead of the file
    # key (Go reference: config.go PrivValidatorListenAddr, wired at
    # node.go:663).
    priv_validator_laddr: str = ""
    # Pin of the remote signer's LINK identity: hex address of the
    # signer sidecar's link key. Without it, whoever dials priv_validator_laddr first
    # wins the pinned slot and the real signer is then rejected — a
    # liveness attack if the laddr is reachable beyond loopback. Set
    # this whenever priv_validator_laddr is not loopback/firewalled.
    priv_validator_signer_id: str = ""
    node_key_file: str = "config/node_key.json"
    # builtin | socket (grpc: refused by the node, ROADMAP Queue A
    # item 9)
    abci: str = "builtin"
    proxy_app: str = "kvstore"
    # gate inbound conns/peers through ABCI /p2p/filter/... queries
    # (reference config.BaseConfig.FilterPeers, node.go:432-466)
    filter_peers: bool = False
    # builtin kvstore: take a state-sync snapshot every N heights
    # (0 = only advertise the live head; reference e2e app
    # snapshot_interval)
    snapshot_interval: int = 0

    def resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.home, path)

    def validate_basic(self) -> None:
        if self.db_backend not in ("sqlite", "filedb", "memdb"):
            raise ValueError(f"unknown db_backend {self.db_backend!r}")
        if self.db_synchronous.upper() not in ("OFF", "NORMAL", "FULL"):
            raise ValueError(
                f"db_synchronous must be OFF|NORMAL|FULL, "
                f"not {self.db_synchronous!r}")


@dataclass
class RPCConfig:
    """reference: config.py:69 RPCConfig. A node refuses `grpc_laddr` at
    construction (ROADMAP Queue A item 9); `pprof_laddr` starts the
    debug server (libs/debugsrv.py)."""

    laddr: str = "tcp://127.0.0.1:26657"
    grpc_laddr: str = ""  # gRPC broadcast API (reference rpc/grpc)
    unsafe: bool = False  # expose unsafe_* / dial_* routes
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit_ms: int = 10000
    max_body_bytes: int = 1000000
    pprof_laddr: str = ""
    # Overload limiter (rpc/jsonrpc.py): at most this many requests in
    # flight at once (0 = unlimited), and a token-bucket request rate
    # with ~1 s of burst (0 = unlimited). Excess requests get a
    # 429-style JSON-RPC error instead of queueing unboundedly.
    max_concurrent_requests: int = 256
    rate_limit_rps: float = 0.0

    def validate_basic(self) -> None:
        if self.timeout_broadcast_tx_commit_ms < 0:
            raise ValueError("negative broadcast timeout")
        if self.max_concurrent_requests < 0:
            raise ValueError("negative max_concurrent_requests")
        if self.rate_limit_rps < 0:
            raise ValueError("negative rate_limit_rps")


@dataclass
class ConsensusConfig:
    """The consensus section (reference: config.py ConsensusConfig; Go
    config/config.go:846-875): the WAL, the round timeouts, the vote
    micro-batching and the receive funnel's bounds."""

    wal_file: str = "data/cs.wal/wal"
    timeout_propose_ms: int = 3000
    timeout_propose_delta_ms: int = 500
    timeout_prevote_ms: int = 1000
    timeout_prevote_delta_ms: int = 500
    timeout_precommit_ms: int = 1000
    timeout_precommit_delta_ms: int = 500
    timeout_commit_ms: int = 1000
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ms: int = 0
    double_sign_check_height: int = 0
    peer_gossip_sleep_ms: int = 100
    peer_query_maj23_sleep_ms: int = 2000
    # Micro-batch vote verification (consensus/state.py VoteScheduler):
    # incoming votes accumulate for up to vote_batch_window_ms (or until
    # vote_batch_max) and are verified as one device batch off the event
    # loop; 0 disables batching and verifies each vote synchronously
    # like the Go reference.
    vote_batch_window_ms: float = 2.0
    vote_batch_max: int = 1024
    # Overload bounds (libs/overload.py): the serialized receive funnel
    # is split by class — vote/proposal messages get a blocking
    # (backpressure) queue, block parts / catchup data a shed-when-full
    # queue — and the vote-scheduler buffer is capped (excess peer votes
    # are shed and re-gossiped via votebits reconciliation once
    # pressure clears).
    peer_funnel_votes_size: int = 1024
    peer_funnel_data_size: int = 512
    vote_buf_max: int = 4096

    def propose_timeout(self, round_: int) -> float:
        return (self.timeout_propose_ms
                + self.timeout_propose_delta_ms * round_) / 1000

    def prevote_timeout(self, round_: int) -> float:
        return (self.timeout_prevote_ms
                + self.timeout_prevote_delta_ms * round_) / 1000

    def precommit_timeout(self, round_: int) -> float:
        return (self.timeout_precommit_ms
                + self.timeout_precommit_delta_ms * round_) / 1000

    def commit_timeout(self) -> float:
        return self.timeout_commit_ms / 1000

    def validate_basic(self) -> None:
        for name in ("timeout_propose_ms", "timeout_propose_delta_ms",
                     "timeout_prevote_ms", "timeout_prevote_delta_ms",
                     "timeout_precommit_ms", "timeout_precommit_delta_ms",
                     "timeout_commit_ms", "create_empty_blocks_interval_ms",
                     "double_sign_check_height"):
            if getattr(self, name) < 0:
                raise ValueError(f"negative {name}")
        for name in ("peer_funnel_votes_size", "peer_funnel_data_size",
                     "vote_buf_max"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")


@dataclass
class CryptoConfig:
    """Verify-backend intent + launch-ledger sizing (reference:
    config.py:391 CryptoConfig), for crypto/cuda/{watchdog,ledger}.py.

    `backend` is the operator's promise, not a dispatch switch: the
    verify paths keep their own breaker-aware device/host ladder
    regardless. With the accelerator named, the watchdog degrades the
    /status device check when launches land on the CPU, raise, go
    silent past the window or drift past a baseline; "auto" (default)
    and "cpu" never degrade on it. "gpu" names the card; the
    reference's "tpu" is read as the same promise, so that a file
    loads in either package."""

    backend: str = "auto"
    # effective-backend classification window: how long without a
    # successful device launch before the watchdog calls the plane
    # idle/degraded
    watchdog_window_s: float = 60.0
    # bounded launch-ledger ring (records, process-global; ~1 KB each)
    ledger_capacity: int = 512

    def validate_basic(self) -> None:
        if self.backend not in ("auto", "gpu", "tpu", "cpu"):
            raise ValueError(
                f"unknown crypto.backend {self.backend!r} "
                "(want auto|gpu|tpu|cpu)")
        if self.watchdog_window_s <= 0:
            raise ValueError("crypto.watchdog_window_s must be positive")
        if self.ledger_capacity < 16:
            raise ValueError("crypto.ledger_capacity must be >= 16")


def fast_consensus_config() -> ConsensusConfig:
    """Short timeouts for in-process tests (reference: config.py
    fast_consensus_config; Go's 10 ms timeout-commit test config,
    config/config.go:867-875)."""
    return ConsensusConfig(
        timeout_propose_ms=400, timeout_propose_delta_ms=100,
        timeout_prevote_ms=200, timeout_prevote_delta_ms=100,
        timeout_precommit_ms=200, timeout_precommit_delta_ms=100,
        timeout_commit_ms=20, skip_timeout_commit=True,
    )


@dataclass
class P2PConfig:
    """reference: config.py:96 P2PConfig (Go config/config.go P2PConfig)."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_ms: int = 100
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5120000
    recv_rate: int = 5120000
    pex: bool = True
    seed_mode: bool = False
    allow_duplicate_ip: bool = False
    handshake_timeout_s: int = 20
    dial_timeout_s: int = 3
    # PEX ensure-peers cadence (reference: PEXReactor
    # ensurePeersPeriod, 30s). Short-lived test nets lower it so
    # seed-bootstrap discovery converges within the run.
    pex_ensure_period_s: float = 30.0
    # Slow-peer escalation (p2p/switch.py + libs/overload.py
    # SlowPeerTracker): a peer whose unsent backlog
    # (pending_send_bytes) sits at/above the high-water mark for
    # consecutive scan intervals escalates skip-gossip -> demote ->
    # disconnect (non-persistent only). 0 high-water disables.
    slow_peer_pending_bytes: int = 1 << 20
    slow_peer_check_interval_s: float = 2.0
    slow_peer_skip_strikes: int = 2
    slow_peer_demote_strikes: int = 4
    slow_peer_disconnect_strikes: int = 8

    def validate_basic(self) -> None:
        if self.max_num_inbound_peers < 0 or self.max_num_outbound_peers < 0:
            raise ValueError("negative peer limits")
        if self.flush_throttle_ms < 0:
            raise ValueError("negative flush throttle")
        if self.pex_ensure_period_s <= 0:
            raise ValueError("pex_ensure_period_s must be positive")
        if self.slow_peer_pending_bytes < 0:
            raise ValueError("negative slow_peer_pending_bytes")
        if self.slow_peer_check_interval_s <= 0:
            raise ValueError("slow_peer_check_interval_s must be positive")
        if not (0 < self.slow_peer_skip_strikes
                <= self.slow_peer_demote_strikes
                <= self.slow_peer_disconnect_strikes):
            raise ValueError(
                "slow_peer strikes must satisfy 0 < skip <= demote "
                "<= disconnect")


@dataclass
class StateSyncConfig:
    """reference: config.py:232 StateSyncConfig. `rpc_servers` names the
    RPC servers the node's light client reads light blocks from
    (light/provider.py RPCProvider), `trust_height` and `trust_hash`
    its root of trust."""

    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_s: int = 168 * 3600
    discovery_time_s: int = 15
    # the node hands these to its Syncer (the reference's node reads
    # neither: its syncer runs the constants these defaults equal)
    chunk_request_timeout_s: int = 10
    chunk_fetchers: int = 4

    def validate_basic(self) -> None:
        if self.enable and self.trust_height <= 0:
            raise ValueError("statesync requires trust_height")
        if self.chunk_fetchers < 1:
            raise ValueError("statesync.chunk_fetchers must be at least 1")
        if self.chunk_request_timeout_s <= 0:
            raise ValueError(
                "statesync.chunk_request_timeout_s must be positive")


@dataclass
class FastSyncConfig:
    """reference: config.py:248 FastSyncConfig."""

    version: str = "v0"
    # Verify-ahead window pipelining (blockchain/verify_ahead.py
    # WindowPipeline): window W+1's commit-signature batch verifies in
    # an executor thread while window W's blocks execute. Verdicts and
    # persistence order are identical either way — disable only to
    # take executor-thread contention off a constrained host.
    verify_ahead: bool = True

    def validate_basic(self) -> None:
        if self.version not in ("v0", "v2"):
            raise ValueError(f"unknown fastsync version {self.version}")


@dataclass
class MempoolConfig:
    """The mempool section (reference: config.py:147 MempoolConfig):
    every field, the admission plane's knobs among them."""

    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = ""
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576
    # CheckTx admission control: reject with MempoolBusyError when
    # this many CheckTx requests are already in flight on the ABCI
    # mempool connection (0 = unlimited) — a saturated app window must
    # shed new admissions, not queue them unboundedly.
    checktx_max_inflight: int = 1024
    # Device-offloaded signature pre-verification in front of CheckTx
    # (mempool/admission.py): txs carrying a types/tx_envelope.py
    # signature envelope are coalesced into batched ed25519 verify
    # launches and only signature-valid txs pay the ABCI round trip.
    #   off        — no envelope processing at all
    #   permissive — enveloped txs are pre-verified; unsigned txs pass
    #                through to CheckTx untouched (default)
    #   strict     — unsigned txs are shed too (signed-only chains)
    admission: str = "permissive"
    # micro-batch collector: flush a verify batch at this many txs ...
    admission_batch: int = 256
    # ... or this many ms after the first tx arrives, whichever first
    admission_flush_ms: float = 2.0
    # pre-verify backlog bound (pending + in-verify txs); the newest
    # arrival is shed with a 429-style error when full
    admission_queue: int = 2048

    def validate_basic(self) -> None:
        if self.size < 0 or self.cache_size < 0 or self.max_tx_bytes < 0:
            raise ValueError("negative mempool limits")
        if self.checktx_max_inflight < 0:
            raise ValueError("negative checktx_max_inflight")
        if self.admission not in ("off", "permissive", "strict"):
            raise ValueError(
                f"mempool.admission must be off|permissive|strict, "
                f"not {self.admission!r}")
        if self.admission_batch < 1 or self.admission_queue < 1:
            raise ValueError(
                "admission_batch and admission_queue must be positive")
        if self.admission_flush_ms < 0:
            raise ValueError("negative admission_flush_ms")


@dataclass
class LightConfig:
    """Light-client serving plane (light/serving.py): knobs for the
    shared verification plane requests run through."""

    # verified-header LRU entries (trusting-period-aware)
    cache_size: int = 4096
    # coalesced verify launches flush at this many signature lanes ...
    batch_max: int = 1024
    # ... or this many ms after the first pending check, whichever
    # comes first
    flush_ms: float = 2.0
    # pending-verify backlog bound (parked + in-verify commit checks);
    # the newest request is shed when full. Floor of 2: one
    # non-adjacent verification parks TWO concurrent commit checks, so
    # pending_max=1 would deterministically shed every skipping verify
    # on an otherwise idle plane
    pending_max: int = 1024
    # proxy workers sharing one plane
    workers: int = 2

    def validate_basic(self) -> None:
        for name in ("cache_size", "batch_max", "workers"):
            if getattr(self, name) < 1:
                raise ValueError(f"light.{name} must be positive")
        if self.pending_max < 2:
            raise ValueError(
                "light.pending_max must be >= 2 (a non-adjacent "
                "verification parks two concurrent commit checks)")
        if self.flush_ms < 0:
            raise ValueError("negative light.flush_ms")


@dataclass
class SpeculationConfig:
    """Verify-ahead pipeline (consensus/speculation.py +
    crypto/cuda/resident.py): commit verification launched
    speculatively as precommits arrive, served at commit time from a
    byte-exact template match — misses fall back to the ordinary
    verify path, so these knobs tune performance, never correctness.
    `enabled` is read by the node's assembly alone."""

    enabled: bool = True

    # ResidentArena capacity in signature lanes (sentinel included):
    # a 10,240-lane commit plus headroom. 134 B a lane resident, so the
    # default costs 1.6 MB of device memory. Valsets beyond the
    # capacity speculate on the host path.
    arena_lanes: int = 12288
    # speculation entries kept beyond the current height (fast-sync /
    # catch-up lookahead); entries below height-1 retire on commit
    max_heights_ahead: int = 2
    # micro-batch window: patches accumulate this long after the first
    # pending arrival before a speculative launch (0 launches every
    # drain immediately); read by the plane's asyncio flusher
    flush_ms: float = 2.0

    def validate_basic(self) -> None:
        if self.arena_lanes < 2:
            raise ValueError(
                "speculation.arena_lanes must be >= 2 (one sentinel "
                "lane + at least one real lane)")
        if self.max_heights_ahead < 1:
            raise ValueError(
                "speculation.max_heights_ahead must be positive")
        if self.flush_ms < 0:
            raise ValueError("negative speculation.flush_ms")


@dataclass
class MeshConfig:
    """Multi-device verify fabric (crypto/cuda/{verify,expanded}.py):
    how the device mesh is used by the verify paths. Performance knobs
    only: verdicts are identical on any mesh."""

    # Key-range sharding crossover for the expanded comb tables: sets of
    # at most this many keys replicate their tables on every device
    # (every table read local, no routing); larger sets split them by
    # key range and route each lane to its key's device, which divides
    # each device's table memory by the mesh size and multiplies the
    # largest set by it. 0 = the default (the single-device budget:
    # replicate while it fits, shard beyond). A set too large for one
    # device shards whatever this says.
    expanded_shard_crossover_keys: int = 0
    # Split the speculation plane's arena into per-device shards when a
    # mesh exists (crypto/cuda/resident.py make_arena): each splice
    # uploads only a device's share of the deltas, and each shard
    # carries its own known-answer sentinel.
    arena_shards: bool = True

    def validate_basic(self) -> None:
        if self.expanded_shard_crossover_keys < 0:
            raise ValueError(
                "negative mesh.expanded_shard_crossover_keys")


def apply_mesh(cfg: MeshConfig) -> None:
    """Apply a [mesh] section before anything builds expanded tables or
    a speculation arena (the node's assembly calls it first)."""
    from .crypto.cuda import expanded, resident

    expanded.set_shard_crossover(cfg.expanded_shard_crossover_keys or None)
    resident.set_arena_shards(cfg.arena_shards)


@dataclass
class InstrumentationConfig:
    """reference: config.py:435. `prometheus` starts a listener on
    `prometheus_listen_addr` serving GET /metrics (libs/debugsrv.py)."""

    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    namespace: str = "tendermint"


@dataclass
class ChaosConfig:
    """reference: config.py:442 ChaosConfig. `failpoints` is a
    libs/failpoints.py spec string — e.g.
    "wal.fsync=delay:50;nth=3,device.verify=error" — armed at node
    build time. Config is the STRICT surface: a malformed spec fails
    validate_basic. It takes what the reference takes: the four
    actions and the nth, every, prob and count triggers."""

    failpoints: str = ""

    def validate_basic(self) -> None:
        if self.failpoints:
            from .libs.failpoints import validate_spec

            # the SAME checks install_spec/arm() enforce (dry run):
            # anything that would raise at node build must raise here
            try:
                validate_spec(self.failpoints)
            except ValueError as e:
                raise ValueError(f"[chaos] failpoints: {e}") from None


@dataclass
class TxIndexConfig:
    """reference: config.py:465 (Go config/config.go:976) — which indexer
    backs /tx_search and /block_search: "kv" (default) or "null"
    (indexing disabled; the search RPCs then error)."""

    indexer: str = "kv"

    def validate_basic(self) -> None:
        if self.indexer not in ("kv", "null"):
            raise ValueError(f"unknown tx_index.indexer {self.indexer!r}")


@dataclass
class Config:
    """reference: config.py:478 Config."""

    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    light: LightConfig = field(default_factory=LightConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    fastsync: FastSyncConfig = field(default_factory=FastSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    speculation: SpeculationConfig = field(
        default_factory=SpeculationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(
        default_factory=InstrumentationConfig
    )
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def validate_basic(self) -> None:
        self.base.validate_basic()
        self.rpc.validate_basic()
        self.p2p.validate_basic()
        self.mempool.validate_basic()
        self.light.validate_basic()
        self.statesync.validate_basic()
        self.fastsync.validate_basic()
        self.consensus.validate_basic()
        self.speculation.validate_basic()
        self.mesh.validate_basic()
        self.crypto.validate_basic()
        self.tx_index.validate_basic()
        self.chaos.validate_basic()

    # -- file round trip (flat TOML-ish key=value per [section]) --

    def save(self, path: str) -> None:
        import dataclasses

        lines = []
        for section_name in ("base", "rpc", "p2p", "mempool", "light",
                             "statesync", "fastsync", "consensus",
                             "speculation", "mesh", "crypto",
                             "tx_index", "instrumentation", "chaos"):
            section = getattr(self, section_name)
            lines.append(f"[{section_name}]")
            for f in dataclasses.fields(section):
                v = getattr(section, f.name)
                if isinstance(v, bool):
                    sv = "true" if v else "false"
                elif isinstance(v, list):
                    sv = '"' + ",".join(v) + '"'
                elif isinstance(v, str):
                    sv = f'"{v}"'
                else:
                    sv = str(v)
                lines.append(f"{f.name} = {sv}")
            lines.append("")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write("\n".join(lines))

    @classmethod
    def load(cls, path: str) -> "Config":
        import dataclasses

        cfg = cls()
        section = None
        with open(path) as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = getattr(cfg, line[1:-1], None)
                    continue
                if section is None or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip()
                fld = next(
                    (f for f in dataclasses.fields(section) if f.name == key),
                    None,
                )
                if fld is None:
                    continue
                if fld.type in ("bool", bool):
                    setattr(section, key, val == "true")
                elif fld.type in ("int", int):
                    setattr(section, key, int(val))
                elif fld.type in ("float", float):
                    setattr(section, key, float(val))
                elif fld.type.startswith("list") if isinstance(fld.type, str) else False:
                    s = val.strip('"')
                    setattr(section, key, [x for x in s.split(",") if x])
                else:
                    setattr(section, key, val.strip('"'))
        return cfg
