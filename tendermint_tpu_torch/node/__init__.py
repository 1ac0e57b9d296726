"""Node assembly: wire every subsystem into one running service
(reference: node/__init__.py; Go node/node.go:618 NewNode, :852 OnStart,
:88 DefaultNewNode).

Construction order is the reference's: stores → ABCI conns → handshake →
mempool/evidence/executor → blockchain + consensus + statesync reactors
→ transport/switch/PEX → (optionally) state sync before consensus
starts. The RPC server attaches through `rpc_env()` once the node is
built.

The pprof listener (`rpc.pprof_laddr`) and the Prometheus listener
(`instrumentation.prometheus`) are libs/debugsrv.py servers, started
after the RPC server; `[crypto]` configures the launch ledger's ring and
the watchdog. Left out, each refused with NotImplementedError at
construction: the gRPC broadcast API (`rpc.grpc_laddr`) and ABCI
transport (`base.abci = "grpc"`), ROADMAP Queue A item 9.

The port's fault rule (crypto/batch.py UNCAUGHT): a ``KernelError`` or
``NoDeviceError`` met by an RPC route, by state sync or by any reactor
halts the node through one path, ``Switch.halt`` (``halt``), and
``wait_halted`` re-raises it. ``_run_state_sync`` never falls back to
fast sync on such a fault, where the reference's catches every
exception."""

from __future__ import annotations

import asyncio
import logging
import os

from ..abci.client import ClientCreator
from ..abci.kvstore import KVStoreApp, PersistentKVStoreApp
from ..blockchain.reactor import BlockchainReactor
from ..config import Config
from ..consensus.reactor import ConsensusReactor
from ..consensus.replay import reconcile_and_handshake
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL
from ..crypto.batch import UNCAUGHT
from ..evidence import Pool as EvidencePool
from ..evidence.reactor import EvidenceReactor
from ..libs.db import DB, FileDB, MemDB
from ..libs.net import split_laddr as _split_laddr
from ..libs.service import Service
from ..mempool.clist_mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p.key import NodeKey
from ..p2p.node_info import NodeInfo
from ..p2p.pex.addrbook import AddrBook
from ..p2p.pex.reactor import PEXReactor
from ..p2p.switch import Switch
from ..p2p.transport import Transport
from ..privval import FilePV
from ..proxy import AppConns
from ..state.execution import BlockExecutor
from ..state.store import Store
from ..statesync.reactor import StateSyncReactor
from ..store import BlockStore
from ..types.events import EventBus
from ..types.genesis import GenesisDoc

logger = logging.getLogger("node")


def _refuse_unported(config: Config) -> None:
    """The settings whose surfaces are not ported raise here, before
    the node acquires anything."""
    for on, what, item in (
            (config.rpc.grpc_laddr, "rpc.grpc_laddr (the gRPC broadcast "
             "API)", 9),
            (config.base.abci == "grpc", 'base.abci = "grpc" (the gRPC '
             "ABCI transport)", 9)):
        if on:
            raise NotImplementedError(
                f"{what} is not ported (ROADMAP Queue A item {item})")


def default_app_creator(config: Config):
    """Go reference: proxy.DefaultClientCreator — a builtin app or a
    socket to an external app."""
    name = config.base.proxy_app
    if config.base.abci == "builtin" or name in ("kvstore",
                                                 "merkle-kvstore",
                                                 "counter", "noop"):
        if name in ("kvstore", "merkle-kvstore"):
            from ..abci.kvstore import MerkleKVStoreApp

            db = _db(config, "app", in_memory=False)
            cls = MerkleKVStoreApp if name == "merkle-kvstore" \
                else PersistentKVStoreApp
            return ClientCreator(app=cls(
                db, snapshot_interval=config.base.snapshot_interval))
        if name == "counter":
            from ..abci.counter import CounterApp

            return ClientCreator(app=CounterApp())
        if name == "noop":
            return ClientCreator(app=KVStoreApp())
        raise ValueError(f"unknown builtin app {name!r}")
    if name.startswith("unix://"):
        return ClientCreator(unix_path=name[len("unix://"):])
    host, port = _split_laddr(name, default_host="127.0.0.1")
    if config.base.abci == "grpc":
        return ClientCreator(grpc_addr=(host, port))
    return ClientCreator(addr=(host, port))


def _db(config: Config, name: str, in_memory: bool) -> DB:
    if in_memory:
        return MemDB()
    d = config.base.resolve(config.base.db_dir)
    os.makedirs(d, exist_ok=True)
    backend = config.base.db_backend
    if backend == "sqlite":
        from ..libs.db import SqliteDB

        sq_path = os.path.join(d, f"{name}.sqlite")
        fdb_path = os.path.join(d, f"{name}.db")
        db = SqliteDB(sq_path, synchronous=config.base.db_synchronous)
        sq_empty = next(iter(db.iterate()), None) is None
        if os.path.exists(fdb_path) and sq_empty:
            # A pre-sqlite data dir: silently opening an empty store
            # would restart the node from genesis while the privval
            # state still holds signed heights — a bricked validator.
            # Migrate the FileDB contents in, then shelve the old log.
            logger.warning("migrating %s -> %s (db_backend=sqlite)",
                           fdb_path, sq_path)
            old = FileDB(fdb_path)
            db.write_batch(list(old.iterate()))
            old.close()
            os.replace(fdb_path, fdb_path + ".migrated")
        return db
    if backend == "filedb":
        return FileDB(os.path.join(d, f"{name}.db"))
    if backend == "memdb":
        return MemDB()
    raise ValueError(f"unknown db_backend {backend!r}")


class Node(Service):
    """Go reference: node/node.go Node."""

    def __init__(self, config: Config,
                 priv_validator=None,
                 node_key: NodeKey | None = None,
                 genesis_doc: GenesisDoc | None = None,
                 client_creator: ClientCreator | None = None,
                 state_provider_factory=None,
                 in_memory: bool = False):
        super().__init__(name=f"node.{config.base.moniker}")
        # Fail fast at construction — before any DB/socket/app-conn is
        # acquired — on every construction path (CLI, e2e runner,
        # embedders): an unvalidated typo (tx_index.indexer = "nulll",
        # fastsync.version = "v3", ...) must not silently mean the
        # default behavior, and must not leak half-started resources.
        config.validate_basic()
        _refuse_unported(config)
        self.config = config
        self.genesis_doc = genesis_doc or GenesisDoc.load(
            config.base.resolve(config.base.genesis_file))
        self.node_key = node_key or NodeKey.load_or_gen(
            config.base.resolve(config.base.node_key_file))
        self.priv_validator = priv_validator
        self.client_creator = client_creator or default_app_creator(config)
        self.state_provider_factory = state_provider_factory
        self.in_memory = in_memory
        self._built = False
        # height -> consensus.misbehavior.Misbehavior, applied to the
        # state machine at build time (maverick mode; set before start)
        self.misbehaviors: dict = {}

    @classmethod
    def default_new_node(cls, config: Config) -> "Node":
        """reference: node/node.go:88 DefaultNewNode — file-backed
        keys + builtin app; with priv_validator_laddr set, the signer
        is REMOTE (a SignerClient built during _build) and no file key
        is loaded here (node.go:663)."""
        if config.base.priv_validator_laddr:
            return cls(config)
        pv = FilePV.load_or_generate(
            config.base.resolve(config.base.priv_validator_key_file),
            config.base.resolve(config.base.priv_validator_state_file))
        return cls(config, priv_validator=pv)

    # -- assembly (reference NewNode body) --

    async def _build(self) -> None:
        cfg = self.config
        # MetricsProvider path (Go node.go:110-125): with
        # instrumentation.prometheus on, every subsystem's metric family
        # is constructed here, before any subsystem starts, so the first
        # scrape shows the whole catalog; off, modules materialize
        # lazily (the Nop analogue).
        from ..libs.metrics import metrics_provider

        self.metrics = metrics_provider(cfg.instrumentation)(
            self.genesis_doc.chain_id)
        if cfg.chaos.failpoints:
            # [chaos] failpoints armed before any subsystem starts so
            # boot-path injections (db.set, wal.*) catch the very
            # first writes; config is the strict surface —
            # validate_basic already refused malformed specs.
            from ..libs import failpoints

            failpoints.install_spec(cfg.chaos.failpoints,
                                    source="config", strict=True)
        # [mesh] knobs, applied before any subsystem can build expanded
        # tables or a speculation arena. Applied on every build, so a
        # node with the defaults never inherits an earlier in-process
        # node's settings. [crypto]: the watchdog's promise and window,
        # the launch ledger's ring.
        from ..config import apply_mesh
        from ..crypto.cuda import ledger as _ledger
        from ..crypto.cuda import watchdog as _watchdog

        apply_mesh(cfg.mesh)
        _watchdog.configure(cfg.crypto.backend, cfg.crypto.watchdog_window_s)
        if cfg.crypto.ledger_capacity != _ledger.capacity():
            _ledger.set_capacity(cfg.crypto.ledger_capacity)
        self.block_store = BlockStore(_db(cfg, "blockstore",
                                          self.in_memory))
        self.state_store = Store(_db(cfg, "state", self.in_memory))
        self.event_bus = EventBus()

        self.proxy_app = AppConns(self.client_creator)
        await self.proxy_app.start()

        # Startup reconciliation: WAL tail repair + quarantine
        # inventory + handshake-with-skew-healing. The report is kept
        # on the node (`recovery_report`).
        wal_path = None if self.in_memory else \
            cfg.base.resolve(cfg.consensus.wal_file)
        scan_dirs = [] if self.in_memory else [
            cfg.base.resolve(cfg.base.db_dir),
            os.path.dirname(wal_path) or ".",
        ]
        self.state, recovery_report = await reconcile_and_handshake(
            None, self.state_store, self.block_store, self.genesis_doc,
            self.proxy_app, wal_path=wal_path, scan_dirs=scan_dirs)
        self.recovery_report = recovery_report.to_dict()

        self.evpool = EvidencePool(_db(cfg, "evidence", self.in_memory),
                                   self.state_store, self.block_store)
        from ..state.txindex import (BlockIndexer, IndexerService,
                                     TxIndexer)

        if cfg.tx_index.indexer == "null":
            # reference config/config.go:976: indexing disabled —
            # /tx, /tx_search, /block_search error out (rpc/core.py
            # already guards on None indexers).
            self.tx_indexer = None
            self.block_indexer = None
            self.indexer_service = None
        else:
            self.tx_indexer = TxIndexer(_db(cfg, "txindex",
                                            self.in_memory))
            self.block_indexer = BlockIndexer(
                _db(cfg, "blockindex", self.in_memory))
            self.indexer_service = IndexerService(
                self.tx_indexer, self.event_bus,
                block_indexer=self.block_indexer)
        self.mempool = CListMempool(cfg.mempool, self.proxy_app.mempool,
                                    height=self.state.last_block_height)
        if cfg.mempool.wal_dir:
            # Refill through the FULL admission path (signature
            # pre-verification included): a restart must not re-admit
            # txs the admission plane would now shed.
            refill = await self.mempool.refill_from_wal()
            if refill["pending"]:
                logger.info("mempool WAL refill: %s", refill)
        # Verify-ahead plane (consensus/speculation.py): ConsensusState
        # feeds it proposal BlockIDs + precommits, BlockExecutor serves
        # LastCommit verdicts from its completed launches.
        self.speculation = None
        if cfg.speculation.enabled:
            from ..consensus.speculation import SpeculationPlane

            self.speculation = SpeculationPlane(cfg.speculation)
        self.block_exec = BlockExecutor(
            self.state_store, self.proxy_app.consensus,
            mempool=self.mempool, evidence_pool=self.evpool,
            event_bus=self.event_bus, speculation=self.speculation)

        wal_path = cfg.base.resolve(cfg.consensus.wal_file)
        os.makedirs(os.path.dirname(wal_path), exist_ok=True)
        self.consensus_state = ConsensusState(
            cfg.consensus, self.state, self.block_exec, self.block_store,
            mempool=self.mempool, evpool=self.evpool,
            wal=None if self.in_memory else WAL(wal_path),
            event_bus=self.event_bus, speculation=self.speculation)
        self.consensus_state.misbehaviors.update(self.misbehaviors)
        if (self.priv_validator is None
                and cfg.base.priv_validator_laddr):
            # Remote signer (reference node.go:663): listen on the
            # configured addr and wait until the signer dials in — a
            # validator must not enter consensus without its key, and
            # the reference listener waits indefinitely (a slow HSM
            # box must not crash node startup). The link runs the
            # SecretConnection STS handshake keyed on this node's
            # node key — never plaintext over TCP.
            from ..privval.signer import SignerClient

            host, port = _split_laddr(cfg.base.priv_validator_laddr,
                                      default_host="127.0.0.1")
            pin = cfg.base.priv_validator_signer_id.strip()
            sc = SignerClient(self.genesis_doc.chain_id, timeout=30.0,
                              conn_key=self.node_key.priv_key,
                              expected_signer_addr=(
                                  bytes.fromhex(pin) if pin else None))
            bound = await sc.listen(host, port)
            while True:
                logger.info("waiting for remote signer on %s:%s",
                            host, bound)
                try:
                    await sc.wait_connected()
                    break
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # ANY stray connection (port scanner, handshake
                    # garbage, wrong key) must not crash startup —
                    # keep waiting for the real signer.
                    logger.warning("remote signer not ready (%r); "
                                   "still waiting", e)
            logger.info("remote signer connected (validator %s)",
                        sc.get_pub_key().address().hex()[:12])
            self.priv_validator = sc
            self._signer_client = sc
        if self.priv_validator is not None:
            self.consensus_state.set_priv_validator(self.priv_validator)

        # A net whose ONLY validator is us has nobody to sync from:
        # both sync modes would wait for peers forever, so they are
        # disabled (reference node.go:677,702 onlyValidatorIsUs).
        solo = self._only_validator_is_us()
        state_sync = cfg.statesync.enable and not solo and \
            self.state.last_block_height == 0
        fast_sync = cfg.base.fast_sync and not solo
        wait_sync = fast_sync or state_sync
        self.consensus_reactor = ConsensusReactor(
            self.consensus_state, wait_sync=wait_sync,
            gossip_sleep=cfg.consensus.peer_gossip_sleep_ms / 1000.0)
        # the origin tag's node label: the configured moniker
        self.consensus_state.trace_node = cfg.base.moniker
        self.bc_reactor = BlockchainReactor(
            self.state, self.block_exec, self.block_store,
            fast_sync=fast_sync and not state_sync,
            consensus_reactor=self.consensus_reactor,
            verify_ahead=cfg.fastsync.verify_ahead)
        self.mempool_reactor = MempoolReactor(
            self.mempool, broadcast=cfg.mempool.broadcast)
        self.ev_reactor = EvidenceReactor(self.evpool)
        if state_sync and self.state_provider_factory is not None:
            provider = self.state_provider_factory(self)
        elif state_sync and cfg.statesync.rpc_servers and \
                cfg.statesync.trust_hash:
            provider = self._default_state_provider()
        else:
            provider = None
        self.ss_reactor = StateSyncReactor(
            self.proxy_app.snapshot, provider,
            discovery_time=cfg.statesync.discovery_time_s,
            chunk_fetchers=cfg.statesync.chunk_fetchers,
            chunk_timeout=float(cfg.statesync.chunk_request_timeout_s))
        self._state_sync = state_sync and provider is not None

        # p2p
        holder = {}

        def node_info() -> NodeInfo:
            t = holder.get("transport")
            addr = cfg.p2p.external_address or \
                (t.listen_addr if t is not None and t._server else "")
            return NodeInfo(
                node_id=self.node_key.id, listen_addr=addr,
                network=self.genesis_doc.chain_id,
                moniker=cfg.base.moniker,
                channels=bytes([0x00, 0x20, 0x21, 0x22, 0x23, 0x30,
                                0x38, 0x40, 0x60, 0x61]))

        # Inbound conn/peer filters (reference node.go:422-478):
        # dup-IP at accept time unless allowed; ABCI-queried
        # addr/id filters when base.filter_peers is on.
        from ..p2p.conn_set import conn_duplicate_ip_filter

        conn_filters = []
        peer_filters = []
        if not cfg.p2p.allow_duplicate_ip:
            conn_filters.append(conn_duplicate_ip_filter)
        if cfg.base.filter_peers:
            # Both ABCI decisions (addr + id) happen post-handshake in
            # one peer filter: conn filters here are sync and
            # pre-handshake, so the addr query lands one hop later
            # than the reference's — same accept/reject outcome.
            async def abci_peer_filter(ni, socket_addr):
                from ..abci import types as abci

                for path in (f"/p2p/filter/addr/{socket_addr}",
                             f"/p2p/filter/id/{ni.node_id}"):
                    res = await self.proxy_app.query.query(
                        abci.RequestQuery(path=path))
                    if res.code != 0:
                        return f"app rejected ({path}): code {res.code}"
                return None

            peer_filters.append(abci_peer_filter)
        self.transport = Transport(
            self.node_key, node_info,
            handshake_timeout=cfg.p2p.handshake_timeout_s,
            dial_timeout=cfg.p2p.dial_timeout_s,
            conn_filters=conn_filters)
        holder["transport"] = self.transport
        from ..libs.overload import SlowPeerPolicy

        self.switch = Switch(
            self.transport, node_info,
            max_inbound=cfg.p2p.max_num_inbound_peers,
            max_outbound=cfg.p2p.max_num_outbound_peers,
            peer_filters=peer_filters,
            slow_peer_policy=SlowPeerPolicy(
                pending_bytes_hiwater=cfg.p2p.slow_peer_pending_bytes,
                skip_strikes=cfg.p2p.slow_peer_skip_strikes,
                demote_strikes=cfg.p2p.slow_peer_demote_strikes,
                disconnect_strikes=cfg.p2p.slow_peer_disconnect_strikes),
            slow_peer_check_interval_s=cfg.p2p.slow_peer_check_interval_s)
        # Peer-quality bookkeeping: EWMA trust metrics (persisted) fed
        # by reactor behaviour reports; collapsed trust disconnects
        # (behaviour.py, p2p/trust.py — reference behaviour/ + ADR-006)
        from ..behaviour import SwitchReporter
        from ..p2p.trust import TrustMetricStore

        self.switch.reporter = SwitchReporter(
            self.switch,
            TrustMetricStore(_db(cfg, "trust", self.in_memory)))
        self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("blockchain", self.bc_reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("evidence", self.ev_reactor)
        self.switch.add_reactor("statesync", self.ss_reactor)
        if cfg.p2p.pex:
            book_path = None if self.in_memory else \
                cfg.base.resolve("config/addrbook.json")
            self.addr_book = AddrBook(book_path)
            # never book (or redial) ourselves: validators' PEX
            # selections legitimately contain OUR address
            self.addr_book.add_our_address(self.node_key.id)
            self.pex_reactor = PEXReactor(
                self.addr_book,
                seeds=[s for s in cfg.p2p.seeds.split(",") if s],
                seed_mode=cfg.p2p.seed_mode,
                ensure_period=cfg.p2p.pex_ensure_period_s)
            self.switch.add_reactor("pex", self.pex_reactor)
        self._built = True

    # -- lifecycle (reference OnStart node.go:852) --

    def _only_validator_is_us(self) -> bool:
        """Go reference: node.go:312 onlyValidatorIsUs."""
        if self.priv_validator is None:
            return False
        vals = self.state.validators
        if vals is None or len(vals) != 1:
            return False
        return vals.validators[0].address == \
            self.priv_validator.get_pub_key().address()

    async def on_start(self) -> None:
        if not self._built:
            await self._build()
        cfg = self.config
        if self.indexer_service is not None:
            self.indexer_service.start()
        # RPC first, so operators can inspect a node that hangs during
        # sync (Go reference node.go:865 starts RPC before the switch)
        self.rpc_server = None
        if cfg.rpc.laddr:
            from ..rpc.core import serve

            rhost, rport = _split_laddr(cfg.rpc.laddr)
            self.rpc_server, self.rpc_port = await serve(
                self.rpc_env(), rhost, rport)
        # pprof + Prometheus listeners (Go node.go:807-812, :873)
        self.debug_server = None
        if cfg.rpc.pprof_laddr:
            from ..libs.debugsrv import DebugServer

            dhost, dport = _split_laddr(cfg.rpc.pprof_laddr)
            self.debug_server = DebugServer(dhost, dport, node=self)
            self.pprof_port = await self.debug_server.start()
        self.prometheus_server = None
        if cfg.instrumentation.prometheus:
            from ..libs.debugsrv import DebugServer

            phost, pport = _split_laddr(
                cfg.instrumentation.prometheus_listen_addr)
            self.prometheus_server = DebugServer(phost or "0.0.0.0", pport,
                                                 node=self)
            self.prometheus_port = await self.prometheus_server.start()
        host, port = _split_laddr(cfg.p2p.laddr)
        await self.transport.listen(host, port)
        await self.switch.start()
        persistent = [p for p in cfg.p2p.persistent_peers.split(",") if p]
        if persistent:
            self.switch.add_persistent_peers(persistent)
            self.spawn(self.switch.dial_peers_async(persistent,
                                                    persistent=True),
                       "dial-persistent")
        # switch.start() already started every reactor (incl. the
        # fast-sync pool when enabled); what remains is deciding how
        # consensus comes up
        if self._state_sync:
            self.spawn(self._run_state_sync(), "state-sync")
        elif not self.bc_reactor.fast_sync:
            await self.consensus_state.start()

    def halt(self, exc: BaseException) -> None:
        """Halt the node on a port fault (Switch.halt)."""
        self.switch.halt(exc)

    async def wait_halted(self, timeout: float | None = None) -> None:
        """Re-raise what halted the node once it halts."""
        await self.switch.wait_halted(timeout)

    def _default_state_provider(self):
        """Config-driven light-client state provider (Go reference:
        statesync/stateprovider.go NewLightClientStateProvider wired
        from [statesync] rpc_servers + trust height/hash in
        node.go:589): trusted app hashes come from a light client
        bisecting over the configured RPC servers."""
        from ..libs.db import MemDB
        from ..light import Client, LightStore, TrustOptions
        from ..light.provider import RPCProvider
        from ..statesync.stateprovider import LightClientStateProvider

        sc = self.config.statesync
        providers = []
        for server in sc.rpc_servers:
            host, port = _split_laddr(server, default_host="127.0.0.1")
            providers.append(RPCProvider(host, port))
        lc = Client(
            self.genesis_doc.chain_id,
            TrustOptions(period_ns=sc.trust_period_s * 1_000_000_000,
                         height=sc.trust_height,
                         hash=bytes.fromhex(sc.trust_hash)),
            providers[0], providers[1:], LightStore(MemDB()))
        return LightClientStateProvider(
            lc, initial_height=self.genesis_doc.initial_height,
            consensus_params=self.genesis_doc.consensus_params)

    async def _run_state_sync(self) -> None:
        """Snapshot-restore, then fast-sync the tail (Go reference:
        node.go:561 startStateSync). A port fault (UNCAUGHT) halts the
        node and re-raises: the reference falls back to fast sync on
        any exception, which here only an ordinary failure does."""
        try:
            state, commit = await self.ss_reactor.sync()
            self.state_store.bootstrap(state)
            self.block_store.save_seen_commit(state.last_block_height,
                                              commit)
            self.state = state
            await self.bc_reactor.switch_to_fast_sync(state)
            logger.info("state sync done at height %d; fast-syncing tail",
                        state.last_block_height)
        except UNCAUGHT as e:
            self.halt(e)
            raise
        except Exception:
            # Do NOT leave the node a zombie (RPC up, never advancing):
            # fall back to fast-sync/consensus from local state, like a
            # node started without state sync would.
            logger.exception(
                "state sync failed; falling back to fast sync from "
                "local state"
            )
            try:
                # NB: bc_reactor.fast_sync is constructed False whenever
                # state sync is enabled — consult the CONFIG flag.
                if self.config.base.fast_sync:
                    await self.bc_reactor.switch_to_fast_sync(self.state)
                else:
                    await self.consensus_state.start()
            except UNCAUGHT as e:
                self.halt(e)
                raise
            except Exception:
                logger.exception(
                    "fallback after state-sync failure also failed; "
                    "stopping node"
                )
                await self.stop()

    async def on_stop(self) -> None:
        if getattr(self, "_signer_client", None) is not None:
            self._signer_client.close()  # listener socket + link
        if getattr(self, "rpc_server", None) is not None:
            self.rpc_server.close()
        for name in ("debug_server", "prometheus_server"):
            if getattr(self, name, None) is not None:
                getattr(self, name).close()
        if self.indexer_service is not None:
            self.indexer_service.stop()
        if self.consensus_state.is_running:
            await self.consensus_state.stop()
        for r in ("bc_reactor", "mempool_reactor", "ev_reactor"):
            await getattr(self, r).stop()
        await self.consensus_reactor.stop()
        if hasattr(self, "pex_reactor"):
            await self.pex_reactor.stop()
        if self.switch.reporter is not None:
            self.switch.reporter.trust.save()
        await self.switch.stop()
        if hasattr(self.mempool, "close"):
            self.mempool.close()
        await self.proxy_app.stop()

    # -- conveniences --

    @property
    def listen_addr(self) -> str:
        return self.transport.listen_addr

    @property
    def p2p_addr(self) -> str:
        return f"{self.node_key.id}@{self.transport.listen_addr}"

    def rpc_env(self):
        """Handles the RPC layer binds to (Go reference:
        rpc/core/env.go:68 Environment)."""
        from ..rpc.core import Environment

        return Environment(self)
