"""SimNode: a full validator node assembled over the sim transport
(reference: tendermint_tpu/sim/harness.py).

The assembly mirrors tests/p2p_harness.py's P2PNode — real stores,
real kvstore app, real BlockExecutor/ConsensusState, real Switch and
reactors — with three simulation differences:

  * the transport is SimTransport (sim/transport.py): no sockets, no
    crypto handshake, links modeled by SimNetwork;
  * every store sits on MemDBs RETAINED across stop()/start(), so node
    CHURN is a real restart (handshake reconciliation against the kept
    stores) rather than a fresh genesis boot;
  * a deterministic SimMempool feeds proposals (txs injected by the
    scenario load driver — there is no RPC in the loop), so app hashes
    evolve and the app-hash oracle has something to bite on.

Determinism helpers: seeded validator/node keys (sha256-derived, never
``hash()``), a genesis_time 1h ahead of the virtual epoch so every
vote timestamp hits the deterministic block-time+iota floor, and a
process-wide ed25519 verify memo (verification is a pure function; 50
nodes re-verifying the same gossiped vote 50× is pure wall-clock
waste at simulation scale).
"""

from __future__ import annotations

import hashlib

from ..abci.client import ClientCreator
from ..abci.kvstore import PersistentKVStoreApp
from ..behaviour import SwitchReporter
from ..blockchain.reactor import BlockchainReactor
from ..config import ConsensusConfig
from ..consensus.reactor import ConsensusReactor
from ..consensus.replay import handshake_and_load_state
from ..consensus.state import ConsensusState
from ..crypto.ed25519 import Ed25519PrivKey
from ..evidence import Pool as EvidencePool
from ..evidence.reactor import EvidenceReactor
from ..libs.db import MemDB
from ..mempool import Mempool
from ..p2p.key import NodeKey
from ..p2p.node_info import NodeInfo
from ..p2p.switch import Switch
from ..p2p.trust import TrustMetricStore
from ..proxy import AppConns
from ..state.execution import BlockExecutor
from ..state.store import Store
from ..statesync.reactor import StateSyncReactor
from ..store import BlockStore
from ..types.events import EventBus
from ..types.genesis import GenesisDoc, GenesisValidator
from ..types.priv_validator import MockPV
from .clock import VirtualClock
from .network import SimNetwork
from .transport import SimTransport

SIM_PORT = 26656
# consensus 0x20-0x23, evidence 0x38, blockchain 0x40, statesync 0x60/61
SIM_CHANNELS = bytes([0x20, 0x21, 0x22, 0x23, 0x38, 0x40, 0x60, 0x61])


def sim_consensus_config() -> ConsensusConfig:
    """Virtual-time consensus cadence: timeouts are FREE (they advance
    the clock, not the wall), so they stay near production shape; the
    explicit commit timeout paces heights so a scenario's virtual
    duration maps to a predictable height budget (~2/s when healthy)."""
    return ConsensusConfig(
        timeout_propose_ms=1000, timeout_propose_delta_ms=500,
        timeout_prevote_ms=500, timeout_prevote_delta_ms=250,
        timeout_precommit_ms=500, timeout_precommit_delta_ms=250,
        timeout_commit_ms=300, skip_timeout_commit=False,
    )


def sim_priv_key(label: str, i: int) -> Ed25519PrivKey:
    return Ed25519PrivKey(
        hashlib.sha256(f"sim:{label}:{i}".encode()).digest())


def sim_host(index: int) -> str:
    return f"10.{(index >> 8) & 255}.{index & 255}.1"


def sim_genesis(n_nodes: int, seed: int, *, valset_size: int | None = None,
                power: int = 100, phantom_power: int = 1,
                chain_id: str | None = None):
    """Deterministic genesis: one keyed validator per sim node plus
    (valset_size - n_nodes) PHANTOM validators — keyless low-power
    committee members whose commit slots stay ABSENT. They never vote,
    so keep phantom power well under half the keyed power or the net
    cannot reach +2/3; what they buy is commit/valset structures at
    10k-validator scale flowing through the real verify path."""
    pvs = [MockPV(sim_priv_key(f"{seed}:val", i)) for i in range(n_nodes)]
    validators = [GenesisValidator(pv.get_pub_key(), power) for pv in pvs]
    extra = max(0, (valset_size or n_nodes) - n_nodes)
    for j in range(extra):
        pub = sim_priv_key(f"{seed}:phantom", j).pub_key()
        validators.append(GenesisValidator(pub, phantom_power))
    if extra and extra * phantom_power * 2 >= n_nodes * power:
        raise ValueError(
            "phantom power would leave keyed validators below +2/3")
    gdoc = GenesisDoc(
        chain_id=chain_id or f"sim-{seed}",
        # 1h ahead of the virtual epoch: vote times always take the
        # deterministic block_time+iota floor (tests/helpers.py trick)
        genesis_time=VirtualClock.EPOCH_NS + 3600 * 1_000_000_000,
        validators=validators,
    )
    gdoc.validate_and_complete()
    return gdoc, pvs


class SimMempool(Mempool):
    """Deterministic direct-injection mempool (no CheckTx round trip —
    scenario load goes straight in; admission is not what the sim is
    exercising)."""

    def __init__(self):
        self._txs: list[bytes] = []
        self._seen: set[bytes] = set()

    def add(self, tx: bytes) -> bool:
        if tx in self._seen:
            return False
        self._seen.add(tx)
        self._txs.append(tx)
        return True

    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]:
        out, total = [], 0
        for tx in self._txs:
            if max_bytes >= 0 and total + len(tx) > max_bytes:
                break
            out.append(tx)
            total += len(tx)
        return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        return self._txs[:n] if n >= 0 else list(self._txs)

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    async def update(self, height, txs, results,
                     precheck=None, postcheck=None) -> None:
        committed = set(txs)
        self._txs = [t for t in self._txs if t not in committed]
        # committed txs stay in _seen: re-injection must not re-commit

    def size(self) -> int:
        return len(self._txs)

    def tx_bytes(self) -> int:
        return sum(len(t) for t in self._txs)


def install_verify_memo():
    """Memoize Ed25519PubKey.verify_signature process-wide for the
    duration of a sim run (returns the restore function). Verification
    is a pure function of (key, msg, sig); without the memo a 50-node
    net re-verifies every gossiped vote once per node at ~3.5 ms a pop
    of pure-Python ed25519 — the single biggest wall-clock term."""
    from ..crypto.ed25519 import Ed25519PubKey

    orig = Ed25519PubKey.verify_signature
    cache: dict = {}

    def verify(self, msg: bytes, sig: bytes) -> bool:
        key = (self.bytes(), bytes(sig), hashlib.sha256(msg).digest())
        v = cache.get(key)
        if v is None:
            v = cache[key] = orig(self, msg, sig)
        return v

    Ed25519PubKey.verify_signature = verify

    def restore():
        Ed25519PubKey.verify_signature = orig
        cache.clear()

    return restore


class SimNode:
    """A restartable full node over the sim fabric. All four stores
    (app/state/block/evidence) persist across stop()/start() so churn
    exercises the real startup reconciliation path."""

    def __init__(self, index: int, gdoc: GenesisDoc, pv, network: SimNetwork,
                 *, seed: int = 0, config: ConsensusConfig | None = None,
                 gossip_sleep: float = 0.05, snapshot_interval: int = 0,
                 keep_snapshots: int = 4, state_provider_factory=None,
                 run_consensus: bool = True):
        self.index = index
        self.gdoc = gdoc
        self.pv = pv
        self.network = network
        self.gossip_sleep = gossip_sleep
        # statesync roles: snapshot_interval > 0 makes the node a
        # snapshot SERVER; a state_provider_factory(node) makes it a
        # statesync JOINER (run_consensus=False boots it without the
        # consensus loop so a scenario probe can drive
        # ss_reactor.sync() first, mirroring tests/p2p_harness.py)
        self.snapshot_interval = snapshot_interval
        self.keep_snapshots = keep_snapshots
        self.state_provider_factory = state_provider_factory
        self.run_consensus = run_consensus
        self.host = sim_host(index)
        self.port = SIM_PORT
        self.node_key = NodeKey(sim_priv_key(f"{seed}:node", index))
        self.config = config or sim_consensus_config()
        self.app_db = MemDB()
        self.state_db = MemDB()
        self.block_db = MemDB()
        self.ev_db = MemDB()
        self.mempool = SimMempool()
        # byzantine hooks (sim/byzantine.py): outbound conduct filter
        # installed via Switch.peer_wrapper, and a {height: Misbehavior}
        # schedule copied into ConsensusState on every (re)start
        self.conduct = None
        self.misbehavior_schedule: dict = {}
        self.running = False
        self.restarts = -1  # first start() brings it to 0
        self.switch = None
        self.cs = None
        self.block_store = None

    @property
    def addr(self) -> str:
        return f"{self.node_key.id}@{self.host}:{self.port}"

    async def start(self) -> None:
        assert not self.running
        self.app = PersistentKVStoreApp(
            self.app_db, snapshot_interval=self.snapshot_interval,
            keep_snapshots=self.keep_snapshots)
        self.conns = AppConns(ClientCreator(app=self.app))
        await self.conns.start()
        self.state_store = Store(self.state_db)
        self.block_store = BlockStore(self.block_db)
        state = await handshake_and_load_state(
            None, self.state_store, self.block_store, self.gdoc, self.conns)
        self.evpool = EvidencePool(self.ev_db, self.state_store,
                                   self.block_store)
        executor = BlockExecutor(self.state_store, self.conns.consensus,
                                 mempool=self.mempool,
                                 event_bus=EventBus(),
                                 evidence_pool=self.evpool)
        self.cs = ConsensusState(self.config, state, executor,
                                 self.block_store, mempool=self.mempool,
                                 evpool=self.evpool)
        self.cs.trace_node = f"sim{self.index}"
        if self.pv is not None:
            self.cs.set_priv_validator(self.pv)
        self.cs.misbehaviors.update(self.misbehavior_schedule)
        self.reactor = ConsensusReactor(self.cs,
                                        wait_sync=not self.run_consensus,
                                        gossip_sleep=self.gossip_sleep)
        self.bc_reactor = BlockchainReactor(
            state, executor, self.block_store, fast_sync=False,
            consensus_reactor=self.reactor)
        self.ev_reactor = EvidenceReactor(self.evpool)
        provider = (self.state_provider_factory(self)
                    if self.state_provider_factory is not None else None)
        self.ss_reactor = StateSyncReactor(self.conns.snapshot, provider)

        def ni():
            return NodeInfo(node_id=self.node_key.id,
                            listen_addr=f"{self.host}:{self.port}",
                            network=self.gdoc.chain_id,
                            moniker=f"sim{self.index}",
                            channels=SIM_CHANNELS)

        self.transport = SimTransport(self.node_key, ni, self.network,
                                      self.host, self.port)
        self.switch = Switch(self.transport, ni)
        # honest conduct feedback: verified/rejected vote lanes move
        # the EWMA trust metric; collapsed trust disconnects (the
        # behaviour.py surface byzantine scenarios assert against).
        # Interval is VIRTUAL seconds — short so scenarios see decay.
        self.switch.reporter = SwitchReporter(
            self.switch, trust_store=TrustMetricStore(interval_s=5.0))
        if self.conduct is not None:
            from .byzantine import wrap_peer_conduct

            self.switch.peer_wrapper = (
                lambda peer: wrap_peer_conduct(peer, self.conduct))
        self.switch.add_reactor("consensus", self.reactor)
        self.switch.add_reactor("blockchain", self.bc_reactor)
        self.switch.add_reactor("evidence", self.ev_reactor)
        self.switch.add_reactor("statesync", self.ss_reactor)
        await self.transport.listen(self.host, self.port)
        await self.switch.start()
        if self.run_consensus:
            await self.cs.start()
        self.running = True
        self.restarts += 1

    async def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        if self.cs is not None and self.cs.is_running:
            await self.cs.stop()
        # reactors stop via Switch.on_stop, AFTER peers are removed —
        # stopping them directly first would hand _remove_peer a dead
        # reactor mid-teardown
        if self.switch is not None:
            await self.switch.stop()
        await self.conns.stop()

    async def dial(self, other: "SimNode", persistent: bool = True) -> None:
        if persistent:
            self.switch.add_persistent_peers([other.addr])
        await self.switch.dial_peer(other.addr, persistent=persistent)

    # -- observation --

    def height(self) -> int:
        return self.block_store.height if self.block_store is not None else 0

    def block_hash(self, h: int):
        meta = self.block_store.load_block_meta(h)
        return meta.header.hash() if meta is not None else None

    def app_hash_after(self, h: int):
        """The app hash produced by executing height h (recorded in
        header h+1)."""
        meta = self.block_store.load_block_meta(h + 1)
        return meta.header.app_hash if meta is not None else None
