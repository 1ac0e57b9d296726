"""BlockExecutor (reference: state/execution.py; Go
state/execution.go:132).

apply_block: validate → execute on the consensus ABCI connection
(BeginBlock, pipelined DeliverTx, EndBlock) → persist responses →
update state (valset/params deltas) → Commit the app under the mempool
lock → prune → fire events. Named failpoints (libs/failpoints.py)
sit between the persistence steps exactly like the reference's
fail.Fail() calls
(state/execution.go:149-195) so crash-recovery tests can cut the
process at each boundary.

The reference's `state_metrics()` family waits for the port's metrics
layer: its four series are kept in METRICS, a plain dict (the
convention of proxy.METRICS and evidence.METRICS)."""

from __future__ import annotations

import time

from ..abci import types as abci_t
from ..abci.client import Client
from ..libs.failpoints import hit as _failpoint
from ..mempool import Mempool, NopMempool, TxPostCheck, TxPreCheck
from ..types.block import Block, BlockID, Commit
from ..types.events import (
    EventBus, EventDataNewBlock, EventDataNewBlockHeader, EventDataTx,
    EventDataValidatorSetUpdates,
)
from ..types.validator import Validator
from .. import crypto
from . import State, abci_results_hash
from .store import Store
from .validation import validate_block


# the reference's state_metrics(): the two histograms as an observation
# count and a sum of seconds, the two counters as counts
METRICS: dict = {
    "block_processing_seconds": {"count": 0, "sum": 0.0},
    "commit_verify_seconds": {"count": 0, "sum": 0.0},
    "validator_set_updates": 0,
    "consensus_param_updates": 0,
}


def observe(series: str, seconds: float) -> None:
    """One observation of a METRICS histogram."""
    h = METRICS[series]
    h["count"] += 1
    h["sum"] += seconds


class ExecutionError(Exception):
    pass


def validator_updates_from_abci(updates: list[abci_t.ValidatorUpdate]) -> list[Validator]:
    out = []
    for u in updates:
        pk = crypto.pubkey_from_type_and_bytes(u.pub_key_type, u.pub_key)
        v = Validator.new(pk, u.power)
        out.append(v)
    return out


def abci_header_from_block(block: Block) -> dict:
    h = block.header
    return {
        "version_block": h.version_block,
        "version_app": h.version_app,
        "chain_id": h.chain_id,
        "height": h.height,
        "time": h.time,
        "last_block_id": h.last_block_id.hash.hex(),
        "last_commit_hash": h.last_commit_hash.hex(),
        "data_hash": h.data_hash.hex(),
        "validators_hash": h.validators_hash.hex(),
        "next_validators_hash": h.next_validators_hash.hex(),
        "consensus_hash": h.consensus_hash.hex(),
        "app_hash": h.app_hash.hex(),
        "last_results_hash": h.last_results_hash.hex(),
        "evidence_hash": h.evidence_hash.hex(),
        "proposer_address": h.proposer_address.hex(),
    }


def build_last_commit_info(block: Block, state_store: Store,
                           initial_height: int) -> abci_t.LastCommitInfo:
    """Who signed the last block, with powers from the stored valset
    (Go reference: state/execution.go getBeginBlockValidatorInfo)."""
    if block.header.height <= initial_height or block.last_commit is None:
        return abci_t.LastCommitInfo()
    vals = state_store.load_validators(block.header.height - 1)
    if vals is None:
        raise ExecutionError(
            f"no validator set stored for height {block.header.height - 1}"
        )
    votes = []
    for i, cs in enumerate(block.last_commit.signatures):
        val = vals.validators[i]
        votes.append(abci_t.VoteInfo(
            address=val.address,
            power=val.voting_power,
            signed_last_block=not cs.is_absent(),
        ))
    return abci_t.LastCommitInfo(round=block.last_commit.round, votes=votes)


class BlockExecutor:
    def __init__(self, state_store: Store, app_conn: Client,
                 mempool: Mempool | None = None, evidence_pool=None,
                 event_bus: EventBus | None = None, speculation=None):
        self.store = state_store
        self.app = app_conn
        self.mempool = mempool or NopMempool()
        self.evpool = evidence_pool
        self.event_bus = event_bus
        # consensus/speculation.py SpeculationPlane (or None): lets
        # validate_block serve the LastCommit check from a completed
        # verify-ahead launch instead of verifying on the critical path
        self.speculation = speculation

    # -- proposal construction (Go reference: state/execution.go:95-116) --

    def create_proposal_block(self, height: int, state: State,
                              commit: Commit | None,
                              proposer_address: bytes) -> Block:
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = (
            self.evpool.pending_evidence(state.consensus_params.evidence.max_bytes)
            if self.evpool is not None else []
        )
        # data budget: block max minus header/commit/evidence overhead
        max_data = max_data_bytes(max_bytes, len(state.validators), evidence)
        txs = self.mempool.reap_max_bytes_max_gas(max_data, max_gas)
        time_ns = (
            state.last_block_time if height == state.initial_height else None
        )
        if time_ns is None:
            from . import median_time

            time_ns = median_time(commit, state.last_validators)
        return state.make_block(height, txs, commit, evidence,
                                proposer_address, time_ns)

    # -- the apply path --

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block, self.evpool,
                       speculation=self.speculation)

    async def validate_block_async(self, state: State, block: Block) -> None:
        """validate_block in a worker thread: the LastCommit signature
        batch runs on the device without freezing the event loop
        (gossip, RPC and timeouts stay live during a mega-commit
        verify). The reference's TRACER.wrap around it comes with the
        port's tracing."""
        import asyncio

        await asyncio.get_running_loop().run_in_executor(
            None, self.validate_block, state, block
        )

    async def apply_block(self, state: State, block_id: BlockID,
                          block: Block) -> tuple[State, int]:
        """Returns (new_state, retain_height). Raises on invalid block."""
        t0 = time.perf_counter()
        try:
            return await self._apply_block(state, block_id, block)
        finally:
            observe("block_processing_seconds", time.perf_counter() - t0)

    async def _apply_block(self, state: State, block_id: BlockID,
                           block: Block) -> tuple[State, int]:
        await self.validate_block_async(state, block)

        abci_responses = await self._exec_block_on_proxy_app(state, block)

        _failpoint("state.apply.block_executed")

        self.store.save_abci_responses(block.header.height, abci_responses)

        _failpoint("state.apply.responses_saved")

        end_block: abci_t.ResponseEndBlock = abci_responses["end_block"]
        val_updates = validator_updates_from_abci(end_block.validator_updates)
        if val_updates:
            METRICS["validator_set_updates"] += len(val_updates)
        if end_block.consensus_param_updates:
            METRICS["consensus_param_updates"] += 1
        new_state = update_state(state, block_id, block, abci_responses,
                                 val_updates)
        if val_updates:
            # The changed set takes effect at H+2: warm its expanded
            # device tables in the background now so the first commit
            # verify under it doesn't pay the table build inline.
            new_state.next_validators.warm_device_tables()

        # Commit app + update mempool (Go reference: execution.go:210-254)
        app_hash, retain_height = await self._commit(new_state, block,
                                                     abci_responses["deliver_txs"])
        if self.evpool is not None:
            self.evpool.update(new_state, block.evidence.evidence)

        _failpoint("state.apply.app_committed")

        new_state.app_hash = app_hash
        self.store.save(new_state)

        _failpoint("state.apply.state_saved")

        self._fire_events(block, block_id, abci_responses, val_updates)
        return new_state, retain_height

    async def _exec_block_on_proxy_app(self, state: State, block: Block) -> dict:
        """BeginBlock → pipelined DeliverTx×N → EndBlock (Go reference:
        state/execution.go:261). DeliverTx requests are fired without
        awaiting (socket pipelining); gathered before EndBlock."""
        import asyncio

        byz = []
        for ev in block.evidence.evidence:
            byz.extend(ev.to_abci() if hasattr(ev, "to_abci") else [])
        begin = await self.app.begin_block(abci_t.RequestBeginBlock(
            hash=block.hash(),
            header=abci_header_from_block(block),
            last_commit_info=build_last_commit_info(
                block, self.store, state.initial_height
            ),
            byzantine_validators=byz,
        ))
        tasks = [
            self.app.submit(abci_t.RequestDeliverTx(tx))
            for tx in block.data.txs
        ]
        deliver_txs = (
            list(await asyncio.gather(*tasks, return_exceptions=True))
            if tasks else []
        )
        for r in deliver_txs:
            if isinstance(r, BaseException):
                raise ExecutionError(f"DeliverTx failed: {r}")
        end = await self.app.end_block(
            abci_t.RequestEndBlock(block.header.height)
        )
        return {"begin_block": begin, "deliver_txs": deliver_txs, "end_block": end}

    async def _commit(self, state: State, block: Block,
                      deliver_txs: list) -> tuple[bytes, int]:
        """Mempool lock → flush → app Commit → mempool update
        (Go reference: state/execution.go:210-254)."""
        self.mempool.lock()
        try:
            await self.mempool.flush_app_conn()
            res = await self.app.commit()
            await self.mempool.update(
                block.header.height, block.data.txs, deliver_txs,
                TxPreCheck(state.consensus_params.block.max_bytes),
                TxPostCheck(state.consensus_params.block.max_gas),
            )
            return res.data, res.retain_height
        finally:
            self.mempool.unlock()

    def _fire_events(self, block: Block, block_id: BlockID,
                     abci_responses: dict, val_updates) -> None:
        if self.event_bus is None:
            return
        begin = abci_responses["begin_block"]
        end = abci_responses["end_block"]
        self.event_bus.publish_new_block(
            EventDataNewBlock(block, {"events": begin.events},
                              {"events": end.events}),
            begin.events + end.events,
        )
        self.event_bus.publish_new_block_header(
            EventDataNewBlockHeader(block.header, len(block.data.txs))
        )
        for i, tx in enumerate(block.data.txs):
            r = abci_responses["deliver_txs"][i]
            self.event_bus.publish_tx(
                EventDataTx(block.header.height, tx, i, {
                    "code": r.code, "log": r.log, "events": r.events,
                }),
                r.events,
            )
        if val_updates:
            self.event_bus.publish_validator_set_updates(
                EventDataValidatorSetUpdates(val_updates)
            )


def update_state(state: State, block_id: BlockID, block: Block,
                 abci_responses: dict, val_updates: list[Validator]) -> State:
    """Pure state transition (Go reference: state/execution.go:406)."""
    height = block.header.height
    next_vals = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if val_updates:
        next_vals.update_with_change_set(val_updates)
        last_height_vals_changed = height + 1 + 1  # takes effect at H+2

    next_vals.increment_proposer_priority(1)

    params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    end_block: abci_t.ResponseEndBlock = abci_responses["end_block"]
    if end_block.consensus_param_updates:
        params = params.update(end_block.consensus_param_updates)
        last_height_params_changed = height + 1

    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=height,
        last_block_id=block_id,
        last_block_time=block.header.time,
        next_validators=next_vals,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=abci_results_hash(abci_responses["deliver_txs"]),
        app_hash=b"",  # set after Commit
        app_version=params.version.app_version,
    )


def max_data_bytes(max_bytes: int, num_validators: int, evidence: list) -> int:
    """Bytes available for txs once header, commit and evidence are
    accounted for (Go reference: types/block.go MaxDataBytes)."""
    from ..types.block import MAX_HEADER_BYTES

    commit_overhead = 110 * num_validators + 100
    ev_bytes = sum(len(e.to_bytes()) + 16 for e in evidence)
    out = max_bytes - MAX_HEADER_BYTES - commit_overhead - ev_bytes - 64
    return max(out, 1024)
