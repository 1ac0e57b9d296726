"""Handshake block-replay + startup reconciliation (reference:
consensus/replay.py; Go consensus/replay.go:201-420).

On boot, reconcile three heights: the app's (ABCI Info), the state
store's, and the block store's. The app may be behind (crashed before
Commit) — replay stored blocks into it; tendermint state may be one
behind the block store (crashed between SaveBlock and ApplyBlock) —
re-apply the last block through the full executor path.

The Handshaker doubles as an explicit RECONCILER: every legal
cross-store skew a commit-pipeline crash can leave (see
libs/failpoints.py COMMIT_PIPELINE) is enumerated, healed, and recorded in a
RecoveryReport — each repair named from the closed REPAIR_KINDS
catalog and counted in the reference's recovery family
(libs/metrics.py recovery_metrics: repairs by kind, blocks replayed,
quarantined files); the node keeps the report for GET /status."""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

from ..abci import types as abci_t
from ..abci.client import Client
from ..state import State as SmState, make_genesis_state
from ..state.execution import (
    BlockExecutor, abci_header_from_block, build_last_commit_info,
    validator_updates_from_abci,
)
from ..state.store import Store
from ..store import BlockStore
from ..types.genesis import GenesisDoc

logger = logging.getLogger("consensus.replay")

class HandshakeError(Exception):
    pass


# The closed catalog of startup repairs (the reference's, kind for kind;
# RecoveryReport.record refuses any other).
REPAIR_KINDS: dict[str, str] = {
    "wal_torn_tail":
        "corrupt consensus-WAL head tail quarantined and truncated "
        "(crash mid-append)",
    "app_replay":
        "app behind the block store: stored blocks re-executed into "
        "the app, exec-only (crash before the app's Commit)",
    "state_reapply":
        "tendermint state one behind the block store: the last stored "
        "block re-applied through the full executor path (crash "
        "between save_block and apply_block)",
    "state_from_responses":
        "state behind an app that already committed: state brought "
        "forward from the saved ABCI responses without re-executing "
        "(crash between app Commit and the state save)",
}


@dataclass
class RecoveryReport:
    """What the startup reconciler found and did (the reference keeps it
    on the Node and renders it in /status, which come with the node's
    assembly)."""

    app_height: int = 0
    state_height: int = 0
    store_height: int = 0
    wal_end_height: int | None = None
    wal_tail_repaired_bytes: int = 0
    quarantined_files: list[str] = field(default_factory=list)
    repairs: list[dict] = field(default_factory=list)
    blocks_replayed: int = 0

    def record(self, kind: str, detail: str = "", blocks: int = 0) -> None:
        assert kind in REPAIR_KINDS, kind
        self.repairs.append({"kind": kind, "detail": detail})
        self.blocks_replayed += blocks
        logger.warning("startup recovery: %s — %s", kind, detail)
        try:
            from ..libs.metrics import recovery_metrics

            m = recovery_metrics()
            m.repairs.inc(kind=kind)
            if blocks:
                m.blocks_replayed.inc(blocks)
        except Exception:  # pragma: no cover - metrics never fatal
            pass

    def to_dict(self) -> dict:
        return {
            "app_height": self.app_height,
            "state_height": self.state_height,
            "store_height": self.store_height,
            "wal_end_height": self.wal_end_height,
            "wal_tail_repaired_bytes": self.wal_tail_repaired_bytes,
            "quarantined_files": list(self.quarantined_files),
            "repairs": list(self.repairs),
            "blocks_replayed": self.blocks_replayed,
        }


class _MockReplayClient(Client):
    """Stands in for the app when replaying a block it has already
    committed: answers from the ABCI responses saved at apply time and
    reports the app's own hash on Commit, so tendermint state catches
    up without double-executing (Go reference replay.go:370-415)."""

    def __init__(self, saved_responses: dict | None, app_hash: bytes):
        super().__init__(name="abci.MockReplayClient")
        self._saved = saved_responses
        self._app_hash = app_hash
        self._tx_i = 0

    async def deliver(self, req):
        if isinstance(req, abci_t.RequestBeginBlock):
            return (self._saved or {}).get("begin_block") \
                or abci_t.ResponseBeginBlock()
        if isinstance(req, abci_t.RequestDeliverTx):
            txs = (self._saved or {}).get("deliver_txs") or []
            r = (txs[self._tx_i] if self._tx_i < len(txs)
                 else abci_t.ResponseDeliverTx())
            self._tx_i += 1
            return r
        if isinstance(req, abci_t.RequestEndBlock):
            return (self._saved or {}).get("end_block") \
                or abci_t.ResponseEndBlock()
        if isinstance(req, abci_t.RequestCommit):
            return abci_t.ResponseCommit(data=self._app_hash)
        raise HandshakeError(f"mock replay client got {type(req).__name__}")


class Handshaker:
    def __init__(self, state_store: Store, state: SmState,
                 block_store: BlockStore, genesis_doc: GenesisDoc,
                 event_bus=None, report: RecoveryReport | None = None):
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis_doc = genesis_doc
        self.event_bus = event_bus
        self.n_blocks_replayed = 0
        self.report = report if report is not None else RecoveryReport()

    async def handshake(self, app_conns) -> bytes:
        """Returns the app hash both sides agree on after replay."""
        info = await app_conns.query.info(abci_t.RequestInfo(
            version="tendermint_tpu", block_version=11, p2p_version=8,
        ))
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")

        state = self.initial_state
        state.app_version = info.app_version or state.app_version

        app_hash = await self.replay_blocks(state, app_hash, app_height,
                                            app_conns)
        return app_hash

    async def replay_blocks(self, state: SmState, app_hash: bytes,
                            app_height: int, app_conns) -> bytes:
        """reference replay.go:285 replayBlocks — all height cases."""
        store_height = self.block_store.height
        state_height = state.last_block_height
        rep = self.report
        rep.app_height = app_height
        rep.state_height = state_height
        rep.store_height = store_height

        # genesis: app has never seen InitChain
        if app_height == 0 and state_height == 0:
            vals = [
                abci_t.ValidatorUpdate(
                    v.pub_key.type_name, v.pub_key.bytes(), v.voting_power
                )
                for v in state.validators.validators
            ]
            res = await app_conns.consensus.init_chain(abci_t.RequestInitChain(
                time=self.genesis_doc.genesis_time,
                chain_id=self.genesis_doc.chain_id,
                consensus_params=state.consensus_params.to_json(),
                validators=vals,
                app_state_bytes=(
                    __import__("json").dumps(self.genesis_doc.app_state).encode()
                    if self.genesis_doc.app_state is not None else b""
                ),
                initial_height=self.genesis_doc.initial_height,
            ))
            if store_height == 0:
                # app may amend genesis valset / params / app hash
                if res.validators:
                    updates = validator_updates_from_abci(res.validators)
                    from ..types.validator_set import ValidatorSet

                    if not state.validators.validators:
                        state.validators = ValidatorSet(updates)
                        state.next_validators = state.validators.copy()
                        state.next_validators.increment_proposer_priority(1)
                    else:
                        state.next_validators = state.validators.copy()
                if res.app_hash:
                    state.app_hash = res.app_hash
                    app_hash = res.app_hash
                self.state_store.save(state)

        if store_height == 0:
            self._assert_app_hash(state, app_hash)
            return app_hash

        if store_height < app_height:
            raise HandshakeError(
                f"app height {app_height} ahead of block store {store_height}"
            )
        if state_height > store_height:
            raise HandshakeError(
                f"state height {state_height} ahead of block store {store_height}"
            )

        # replay blocks the app is missing, exec-only (no state updates)
        first = app_height + 1
        # the last block needs the FULL apply path if tendermint state is
        # also behind (crash between SaveBlock and ApplyBlock)
        full_apply_last = state_height < store_height
        exec_until = store_height - 1 if full_apply_last else store_height

        for h in range(first, exec_until + 1):
            app_hash = await self._exec_block(h, app_conns)
            self.n_blocks_replayed += 1
        if exec_until >= first:
            rep.record(
                "app_replay",
                f"re-executed stored blocks {first}..{exec_until} into "
                f"the app (app was at {app_height})",
                blocks=exec_until - first + 1)

        if full_apply_last:
            block = self.block_store.load_block(store_height)
            if block is None:
                raise HandshakeError(f"missing block {store_height}")
            prev_state = self.state_store.load() or state
            if store_height >= first:
                # app is also missing this block: full apply drives it
                client = app_conns.consensus
                rep.record(
                    "state_reapply",
                    f"re-applied block {store_height} through the full "
                    f"executor path (state was at {state_height})",
                    blocks=1)
            else:
                # app already committed it (crash between app Commit and
                # state save) — bring ONLY tendermint state forward, via
                # a mock client replaying the saved ABCI responses
                # (reference replay.go:370-415 newMockProxyApp).
                client = _MockReplayClient(
                    self.state_store.load_abci_responses(store_height),
                    app_hash,
                )
                rep.record(
                    "state_from_responses",
                    f"rebuilt state for block {store_height} from saved "
                    f"ABCI responses (app already committed it)",
                    blocks=1)
            executor = BlockExecutor(self.state_store, client,
                                     event_bus=self.event_bus)
            new_state, _ = await executor.apply_block(
                prev_state, block.block_id(), block
            )
            app_hash = new_state.app_hash
            self.n_blocks_replayed += 1

        self._assert_app_hash(self.state_store.load() or state, app_hash)
        return app_hash

    async def _exec_block(self, height: int, app_conns) -> bytes:
        """Execute one stored block against the app WITHOUT touching
        tendermint state (reference replay.go applyBlock-to-proxy path)."""
        import asyncio

        block = self.block_store.load_block(height)
        if block is None:
            raise HandshakeError(f"missing block {height} in store")
        client: Client = app_conns.consensus
        await client.begin_block(abci_t.RequestBeginBlock(
            hash=block.hash(),
            header=abci_header_from_block(block),
            last_commit_info=build_last_commit_info(
                block, self.state_store,
                self.initial_state.initial_height,
            ),
        ))
        tasks = [client.submit(abci_t.RequestDeliverTx(tx))
                 for tx in block.data.txs]
        if tasks:
            await asyncio.gather(*tasks)
        await client.end_block(abci_t.RequestEndBlock(height))
        res = await client.commit()
        return res.data

    def _assert_app_hash(self, state: SmState, app_hash: bytes) -> None:
        if state.last_block_height > 0 and state.app_hash != app_hash:
            raise HandshakeError(
                f"app hash mismatch after replay: state "
                f"{state.app_hash.hex()} != app {app_hash.hex()}"
            )


def _reconcile_wal(wal_path: str, report: RecoveryReport) -> None:
    """Pre-handshake WAL reconciliation: quarantine+truncate a torn
    head tail (so consensus catchup replays a clean record sequence)
    and note the newest committed-height marker for the report. The
    consensus loop re-opens the WAL for append later; repair() here is
    idempotent — a clean head is a no-op."""
    from .wal import WAL, EndHeightMessage

    if not os.path.exists(wal_path):
        return
    w = WAL(wal_path)
    try:
        # ONE decode pass serves both the torn-tail check and the
        # end-height scan (a boot-time WAL head can be 10 MB; decoding
        # it once per question adds up).
        msgs, consumed, size = WAL._decode_file(wal_path)
        torn = size - consumed
        if torn > 0 and w.repair():
            report.wal_tail_repaired_bytes = torn
            report.record(
                "wal_torn_tail",
                f"quarantined {torn} torn tail bytes of {wal_path}")
        end = None
        for msg in msgs:
            if isinstance(msg.msg, EndHeightMessage):
                end = msg.msg.height
        if end is None:
            # the newest marker may sit in a rotated segment (crash
            # right after a rotation leaves an empty/markerless head):
            # walk older segments newest-first, stop at the first hit
            for seg in reversed(w.segment_paths()[:-1]):
                for msg in w._read_segment(seg):
                    if isinstance(msg.msg, EndHeightMessage):
                        end = msg.msg.height
                if end is not None:
                    break
        report.wal_end_height = end
    finally:
        w.close()


def _scan_quarantine(dirs, report: RecoveryReport) -> None:
    """List corruption-evidence files (`*.corrupt.NNN` from FileDB
    replay and WAL repair — including the one a _reconcile_wal call
    just wrote) into the report and recovery_quarantined_files, so
    accumulated evidence is seen instead of discovered by du(1) years
    later."""
    found: list[str] = []
    for d in dict.fromkeys(d for d in dirs if d):
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if ".corrupt." in name:
                found.append(os.path.join(d, name))
    report.quarantined_files = found
    from ..libs.metrics import recovery_metrics

    recovery_metrics().quarantined_files.set(len(found))


async def reconcile_and_handshake(
    config, state_store: Store, block_store: BlockStore,
    genesis_doc: GenesisDoc, app_conns, event_bus=None,
    wal_path: str | None = None, scan_dirs=(),
) -> tuple[SmState, RecoveryReport]:
    """Full startup reconciliation: repair the WAL tail, inventory
    quarantined evidence, load-or-genesis state, handshake the app
    (healing every legal cross-store skew), and return the
    post-handshake state plus the RecoveryReport describing what was
    found and repaired (the node assembly entry point)."""
    report = RecoveryReport()
    _scan_quarantine(list(scan_dirs), report)
    if wal_path:
        _reconcile_wal(wal_path, report)
        # the repair may have just minted a quarantine file: rescan
        if report.wal_tail_repaired_bytes:
            _scan_quarantine(list(scan_dirs), report)
    state = state_store.load()
    if state is None:
        state = make_genesis_state(genesis_doc)
        state_store.save(state)
    h = Handshaker(state_store, state, block_store, genesis_doc,
                   event_bus, report=report)
    await h.handshake(app_conns)
    # report.{app,state,store}_height stay as replay_blocks recorded
    # them PRE-repair: the skew the boot recovered from, not the healed
    # values.
    state = state_store.load() or state
    return state, report


async def handshake_and_load_state(
    config, state_store: Store, block_store: BlockStore,
    genesis_doc: GenesisDoc, app_conns, event_bus=None,
) -> SmState:
    """Load-or-genesis state, handshake the app, return the
    post-handshake state (compatibility wrapper around
    reconcile_and_handshake for callers that don't keep the report)."""
    state, _ = await reconcile_and_handshake(
        config, state_store, block_store, genesis_doc, app_conns,
        event_bus)
    return state
