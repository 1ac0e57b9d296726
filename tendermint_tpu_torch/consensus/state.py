"""The Tendermint BFT state machine (reference: consensus/state.py; Go
consensus/state.go:85), built around the vote micro-batch scheduler.

One asyncio task serializes everything (the receiveRoutine analogue,
state.go:686-765): peer messages from the two-class receive funnel,
internal messages (our own proposals and votes loop back through the
same queue) and timeouts. Every message that can change state is WAL'd
before it is acted on; an EndHeightMessage delimits committed heights
for crash recovery.

Transitions (state.go:909-1596):
  NewRound → Propose → Prevote → PrevoteWait → Precommit →
  PrecommitWait → Commit → (apply via BlockExecutor) → NewHeight

Votes are not verified one at a time under the VoteSet lock (Go
reference vote_set.go:203): VoteScheduler accumulates them for
vote_batch_window_ms (or until vote_batch_max) and verifies each batch
as ONE device launch in a worker thread (``batch_verdicts``: the
structured K3 route for 128 lanes or more of one set, K4 below), then
tallies them through the state machine's _try_add_vote with the
signature already checked. Duplicate/conflict semantics are preserved
because VoteSet.add_vote re-runs every non-signature check at tally
time; the pubkey each lane was verified against is resolved per
(height, index), and a height's validator mapping never changes, so a
vote cannot be tallied against a different key than it was verified
with. The reference keeps the scheduler's state on ConsensusState; here
VoteScheduler owns it and takes the tally step as a callable.

The reference's tracing spans, its `trace_node` label and its
tpu_metrics() gauges wait for the port's tracing; the consensus metrics
_record_commit_metrics writes are kept in METRICS, a plain dict (the
convention of state.execution.METRICS).

Divergences, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError is never degraded to the
host path. It ends the vote scheduler's task (the reference degrades
the batch to host verification), it is not turned into a nil prevote
or precommit when validating a proposal, and it ends the speculation
plane's flusher. Whatever ends the receive routine, the scheduler or a
commit step halts the node: the service stops and wait_for_height
re-raises the fault (the reference's receive routine halts silently,
and a failure in a commit step reached from its scheduler is logged
as an unprocessable vote).

One more divergence: a late precommit for the previous height (tallied
into last_commit at NewHeight) is fed to the speculation plane too, so
the LastCommit a proposer builds from last_commit is served whole; the
reference feeds the current height's precommits only.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

import numpy as np

from ..config import ConsensusConfig
from ..crypto.batch import UNCAUGHT
from ..libs import clock as _clock
from ..libs.failpoints import hit as _failpoint
from ..libs.overload import CONTROLLER, PriorityFunnel
from ..libs.service import Service
from ..mempool import Mempool, NopMempool
from ..state import State as SmState
from ..state.execution import BlockExecutor
from ..store import BlockStore
from ..types.block import Block, BlockID, Commit, NIL_BLOCK_ID, PartSet
from ..types.events import EventBus, EventDataRoundState, EventDataVote
from ..types.priv_validator import PrivValidator
from ..types.proposal import Proposal
from ..types.vote import Vote, VoteType
from ..types.vote_set import ConflictingVoteError, VoteSet, VoteSetError
from . import messages as m
from .cstypes import HeightVoteSet, RoundState, RoundStep
from .ticker import TimeoutTicker
from .wal import EndHeightMessage, MsgInfo, RoundStateMessage, TimeoutInfo, WAL

logger = logging.getLogger("consensus.state")

VOTE_BUF_QUEUE = "consensus.vote_buf"


def batch_verdicts(batch, chain_id: str) -> np.ndarray:
    """Per-lane verdicts for a vote micro-batch of (vote, peer_id,
    pub_key, valset) entries (runs in the executor, off the event
    loop).

    Lanes group by the validator set each vote resolved against
    (current height vs last-commit precommits); each group routes
    through ValidatorSet._batch_verify_lanes — the same
    structured->bytes->host ladder every commit-verify call site uses,
    so big all-ed25519 bursts hit the expanded comb tables with sign
    bytes assembled inside K3 (VoteSignBatch: one template group per
    distinct (type, height, round, block_id)) instead of shipping full
    sign-byte rows through the general kernel."""
    from ..types.sign_batch import VoteSignBatch

    verdicts = np.zeros(len(batch), bool)
    groups: dict[int, tuple] = {}
    for j, (_vote, _peer, _pk, vals) in enumerate(batch):
        entry = groups.get(id(vals))
        if entry is None:
            groups[id(vals)] = entry = (vals, [])
        entry[1].append(j)
    for vals, idxs in groups.values():
        votes = [batch[j][0] for j in idxs]
        lanes = [v.validator_index for v in votes]
        sigs = [v.signature for v in votes]
        msgs = vals.structured_or_bytes(
            lanes,
            lambda: VoteSignBatch(chain_id, votes),
            lambda: [v.sign_bytes(chain_id) for v in votes],
        )
        _, group_verdicts = vals._batch_verify_lanes(lanes, msgs, sigs)
        verdicts[np.asarray(idxs)] = np.asarray(group_verdicts)
    return verdicts


class VoteScheduler:
    """The vote micro-batch scheduler of one consensus instance.

    ``tally(vote, peer_id, preverified)`` is the state machine's
    add-vote step (ConsensusState._try_add_vote in the reference): it
    is awaited once per vote that verified (preverified=True) and once
    per vote that takes the synchronous path (preverified=False, the
    tally verifies). It takes whatever lock the state machine needs.
    ``new_height`` points the scheduler at the current height's vote
    sets. ``reporter_fn() -> reporter | None`` receives the per-peer
    verified/rejected counts (observe, enforce), as the reactor's trust
    metric does in the reference."""

    def __init__(self, config: ConsensusConfig, chain_id: str, tally):
        self.config = config
        self.chain_id = chain_id
        self._tally = tally
        self.reporter_fn = lambda: None
        self.height = 0
        self.validators = None    # the current height's ValidatorSet
        self.votes = None         # its HeightVoteSet
        self.last_commit = None   # VoteSet of height - 1's precommits
        # (vote, peer_id, pub_key, valset) entries awaiting one batch
        self._vote_buf: list = []
        self._vote_pending = asyncio.Event()
        self._in_batch = False  # a batch is being verified or tallied
        self.task: asyncio.Task | None = None
        CONTROLLER.register(VOTE_BUF_QUEUE, lambda: len(self._vote_buf),
                            config.vote_buf_max, owner=self)

    def new_height(self, height: int, validators, votes,
                   last_commit=None) -> None:
        self.height = height
        self.validators = validators
        self.votes = votes
        self.last_commit = last_commit

    # -- lifecycle --

    def start(self) -> None:
        """Start the batching task on the running loop (a window of 0
        disables batching: every vote takes the synchronous path)."""
        if self.config.vote_batch_window_ms > 0 and self.task is None:
            self.task = asyncio.get_running_loop().create_task(
                self.run(), name="cs-vote-batch")

    async def stop(self) -> None:
        """Cancel the batching task (a task that already ended keeps its
        result for whoever watches it)."""
        task, self.task = self.task, None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        CONTROLLER.unregister(VOTE_BUF_QUEUE, owner=self)

    # -- the receive path --

    async def receive(self, vote: Vote, peer_id: str) -> None:
        """A vote from a peer (or our own, peer_id ""): batched when it
        can be, else tallied synchronously (the reference's receive
        routine, VoteMessage branch)."""
        if self.config.vote_batch_window_ms <= 0 or \
                not self.enqueue(vote, peer_id):
            await self._tally(vote, peer_id, False)

    def enqueue(self, vote: Vote, peer_id: str) -> bool:
        """True if the vote was queued for batch verification (or is a
        known gossip duplicate, or was shed); False -> the caller takes
        the sync path."""
        resolved = self.resolve_vote_pubkey(vote)
        if resolved is None:
            return False
        pk, vals = resolved
        vs = self.target_vote_set(vote)
        if vs is not None and vs.is_duplicate(vote):
            return True  # already tallied; don't burn a device lane
        if len(self._vote_buf) >= self.config.vote_buf_max:
            if not peer_id:
                # our OWN vote (internal loopback): no peer holds it,
                # so a shed here would silently skip our prevote/
                # precommit for the round — take the sync path instead
                return False
            # Shedding a PEER vote (not the sync path: seconds of
            # on-loop crypto is the failure mode this bound prevents)
            # is safe because gossip re-sends votes the votebits
            # reconciliation shows we still lack.
            CONTROLLER.shed(VOTE_BUF_QUEUE)
            self._vote_pending.set()  # make sure the drain is awake
            return True
        # vals rides along so the batch routes through the expanded
        # structured path (validator-index lanes against the SAME set
        # pk was resolved from).
        self._vote_buf.append((vote, peer_id, pk, vals))
        self._vote_pending.set()
        return True

    def target_vote_set(self, vote: Vote):
        if vote.height + 1 == self.height and \
                vote.type == VoteType.PRECOMMIT:
            return self.last_commit
        if vote.height == self.height and self.votes is not None:
            return (self.votes.prevotes(vote.round)
                    if vote.type == VoteType.PREVOTE
                    else self.votes.precommits(vote.round))
        return None

    def resolve_vote_pubkey(self, vote: Vote):
        """(pubkey, validator_set) this vote must verify against, or
        None if it is not addressable right now (wrong height, unknown
        index...) — such votes take the synchronous path, which
        rejects them cheaply before any signature work."""
        if vote.height + 1 == self.height and \
                vote.type == VoteType.PRECOMMIT:
            vals = (self.last_commit.val_set
                    if self.last_commit is not None else None)
        elif vote.height == self.height:
            vals = self.validators
        else:
            return None
        if vals is None:
            return None
        val = vals.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return None
        return val.pub_key, vals

    def pending(self) -> int:
        return len(self._vote_buf)

    async def drain(self) -> None:
        """Return once every queued vote has been verified and tallied
        (re-raises what ended the batching task)."""
        while self._vote_buf or self._in_batch:
            if self.task is None:
                raise RuntimeError("the vote scheduler is not running")
            if self.task.done():
                self.task.result()
                raise RuntimeError("the vote scheduler stopped")
            await asyncio.sleep(0.001)

    # -- the batching task --

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._vote_pending.wait()
            window = self.config.vote_batch_window_ms / 1e3
            # Early flush under pressure: once the buffer passes half
            # its bound, waiting out the batching window only deepens
            # the backlog (and the shedding it causes) — verify NOW.
            if window > 0 and \
                    len(self._vote_buf) < self.config.vote_batch_max and \
                    len(self._vote_buf) * 2 < self.config.vote_buf_max:
                await asyncio.sleep(window)
            batch, self._vote_buf = self._vote_buf, []
            self._vote_pending.clear()
            if not batch:
                continue
            self._in_batch = True
            try:
                await self._verify_and_commit_batch(batch, loop)
            except (asyncio.CancelledError, *UNCAUGHT):
                raise
            except Exception:
                # One bad batch (device error, malformed-but-decodable
                # vote, transient executor failure) must not kill this
                # task: degrade to per-vote HOST verification, still
                # off the event loop, the tally then per vote.
                logger.exception("vote batch of %d failed; degrading to "
                                 "host-verify off-loop", len(batch))
                await self._host_verify_and_commit(batch, loop)
            finally:
                self._in_batch = False

    async def _verify_and_commit_batch(self, batch, loop) -> None:
        if len(batch) > 1:
            # Device (or host-oracle) verify OFF the event loop: gossip,
            # RPC and timeouts keep running during a 10k-lane burst.
            verdicts = await loop.run_in_executor(
                None, batch_verdicts, batch, self.chain_id)
        else:
            verdicts = batch_verdicts(batch, self.chain_id)
        await self._commit(batch, verdicts, "batch-verify")

    async def _host_verify_and_commit(self, batch, loop) -> None:
        chain_id = self.chain_id

        def host_verify_all():
            out = []
            for vote, _pid, pk, _vals in batch:
                try:
                    out.append(pk.verify_signature(
                        vote.sign_bytes(chain_id), vote.signature))
                except Exception:
                    out.append(False)
            return out

        try:
            verdicts = await loop.run_in_executor(None, host_verify_all)
        except Exception:
            logger.exception("degraded host verify failed; dropping batch")
            return
        await self._commit(batch, verdicts, "degraded path")

    async def _commit(self, batch, verdicts, path: str) -> None:
        """Tally every verified vote, then the per-peer trust feedback
        on VERIFIED outcomes: credit good lanes, debit rejected ones
        (a peer streaming well-formed-but-invalid votes decays to a
        stop instead of farming reputation)."""
        per_peer: dict[str, list[int]] = {}  # peer -> [good, bad]
        for (vote, peer_id, _, _), ok in zip(batch, verdicts):
            if peer_id:
                counts = per_peer.setdefault(peer_id, [0, 0])
                counts[0 if ok else 1] += 1
            if not ok:
                logger.debug("%s rejected vote from %r (val %s)", path,
                             peer_id, vote.validator_address.hex())
                continue
            # Per-vote containment: one vote's commit failure must not
            # throw the whole batch to the degraded path, which would
            # re-verify and re-report trust for votes already processed.
            # The port's own faults are not contained.
            try:
                await self._tally(vote, peer_id, True)
            except UNCAUGHT:
                raise
            except Exception:
                logger.exception("dropping unprocessable vote from %r",
                                 peer_id)
        rep = self.reporter_fn()
        if rep is not None:
            for peer_id, (good, bad) in per_peer.items():
                try:
                    rep.observe(peer_id, good=good, bad=bad)
                    if bad:
                        await rep.enforce(peer_id, "invalid vote signature")
                except Exception:
                    logger.exception("trust feedback failed for %r",
                                     peer_id)


# the reference's consensus_metrics() (Go consensus/metrics.go), as
# _record_commit_metrics sets them: gauges hold their last value,
# counters count, and the block-interval histogram is an observation
# count and a sum of seconds
METRICS: dict = {
    "height": 0, "rounds": 0, "validators": 0, "validators_power": 0,
    "missing_validators": 0, "missing_validators_power": 0,
    "byzantine_validators": 0, "byzantine_validators_power": 0,
    "validator_power": 0, "validator_last_signed_height": 0,
    "validator_missed_blocks": 0, "num_txs": 0, "total_txs": 0,
    "block_size_bytes": 0, "block_parts": 0,
    "block_interval_seconds": {"count": 0, "sum": 0.0},
}


@dataclass
class _QueuedMsg:
    msg: object
    peer_id: str


class ConsensusState(Service):
    """One consensus instance (Go consensus/state.go:85 State)."""

    def __init__(self, config: ConsensusConfig, state: SmState,
                 block_exec: BlockExecutor, block_store: BlockStore,
                 mempool: Mempool | None = None, evpool=None,
                 wal: WAL | None = None, event_bus: EventBus | None = None,
                 speculation=None):
        super().__init__(name="consensus.State")
        self.config = config
        # Verify-ahead plane (consensus/speculation.py): fed the
        # proposal BlockID at _set_proposal and every current-height
        # precommit at _add_vote; BlockExecutor serves commit verdicts
        # from it.
        self.speculation = speculation
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool or NopMempool()
        self.evpool = evpool
        self.wal = wal
        self.event_bus = event_bus
        self.priv_validator: PrivValidator | None = None
        self.priv_validator_address: bytes | None = None

        self.rs = RoundState()
        self.state: SmState | None = None
        # Priority-split bounded receive funnel (libs/overload.py):
        # vote/proposal messages block the sender when full
        # (backpressure, the Go reference's peerMsgQueue channel send);
        # block parts / catchup data shed when full.
        self.peer_funnel = PriorityFunnel(
            config.peer_funnel_votes_size, config.peer_funnel_data_size,
            high_queue="consensus.funnel.votes",
            low_queue="consensus.funnel.data")
        self.internal_msg_queue: asyncio.Queue[_QueuedMsg] = asyncio.Queue(1000)
        self.ticker = TimeoutTicker()
        self._replay_mode = False
        # Serializes state transitions between the receive routine and
        # the vote scheduler's tallies (the Go reference's cs.mtx:
        # asyncio tasks interleave at awaits, and step transitions
        # contain awaits).
        self._state_mtx = asyncio.Lock()
        self.scheduler = VoteScheduler(config, state.chain_id, self._tally)
        self._height_done = asyncio.Event()  # pulsed on every commit
        self.fault: BaseException | None = None  # what halted the node
        self._halting: asyncio.Task | None = None
        # reactor hooks: fn(event_name, payload); events: "step",
        # "proposal", "block_part", "vote", "has_vote", "valid_block",
        # and the maverick split events "vote_split"/"proposal_split"
        self.broadcast_hooks: list = []
        # Maverick hook points: height -> Misbehavior, consulted at
        # enter_propose/prevote/precommit (consensus/misbehavior.py).
        # Empty for honest nodes.
        self.misbehaviors: dict = {}

        self.update_to_state(state)
        if state.last_block_height > 0:
            self.reconstruct_last_commit()

    # -- wiring --

    @property
    def reporter_fn(self):
        """() -> reporter | None: receives the per-peer verified/rejected
        vote counts (observe, enforce), as the reactor's trust metric."""
        return self.scheduler.reporter_fn

    @reporter_fn.setter
    def reporter_fn(self, fn) -> None:
        self.scheduler.reporter_fn = fn

    def set_priv_validator(self, pv: PrivValidator | None) -> None:
        self.priv_validator = pv
        self.priv_validator_address = (
            pv.get_pub_key().address() if pv is not None else None
        )

    def _broadcast(self, event: str, payload) -> None:
        for hook in self.broadcast_hooks:
            hook(event, payload)

    # -- lifecycle --

    async def on_start(self) -> None:
        if self.wal is not None:
            await self._catchup_replay()
        self.spawn(self._receive_routine(), name="cs-receive")
        self.scheduler.start()
        if self.scheduler.task is not None:
            self.scheduler.task.add_done_callback(self._on_scheduler_done)
        self._schedule_round0()

    async def on_stop(self) -> None:
        self.ticker.stop()
        # drop overload registrations (owner-checked: a newer in-process
        # node's same-name entries survive)
        self.peer_funnel.close()
        await self.scheduler.stop()
        if self.speculation is not None:
            self.speculation.close()
        if self.wal is not None:
            self.wal.close()

    def _on_scheduler_done(self, task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            self._halt(task.exception())

    def on_task_crash(self, task: asyncio.Task, exc: BaseException) -> None:
        self._halt(exc)

    def _halt(self, exc: BaseException) -> None:
        """Stop the node on a fault; wait_for_height re-raises it."""
        if self.fault is None:
            self.fault = exc
            self.logger.error("consensus halted: %r", exc)
        self._height_done.set()
        if self.is_running and self._halting is None:
            self._halting = asyncio.get_running_loop().create_task(
                self.stop(), name="cs-halt")

    def _schedule_round0(self) -> None:
        # fire NewHeight immediately (start_time already accounts for
        # timeout_commit when coming off a commit)
        delay = max(self.rs.start_time - _clock.monotonic(), 0.0)
        self.ticker.schedule(TimeoutInfo(
            delay, self.rs.height, 0, int(RoundStep.NEW_HEIGHT)
        ))

    # -- state sync between heights (Go updateToState, state.go:566) --

    def update_to_state(self, state: SmState) -> None:
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height != state.last_block_height:
            raise RuntimeError(
                f"update_to_state height mismatch {rs.height} vs "
                f"{state.last_block_height}"
            )
        last_precommits: VoteSet | None = None
        if rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is None or not pc.has_two_thirds_majority():
                raise RuntimeError("commit round has no +2/3 precommits")
            last_precommits = pc

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        validators = state.validators.copy()
        self.rs = RoundState(
            height=height,
            round=0,
            step=RoundStep.NEW_HEIGHT,
            start_time=_clock.monotonic() + (
                self.config.commit_timeout()
                if not self.config.skip_timeout_commit and rs.commit_round > -1
                else 0.0
            ),
            validators=validators,
            votes=HeightVoteSet(state.chain_id, height, validators),
            last_commit=last_precommits,
            last_validators=state.last_validators.copy(),
            commit_round=-1,
            locked_round=-1,
            valid_round=-1,
        )
        self.state = state
        self.scheduler.new_height(height, validators, self.rs.votes,
                                  last_precommits)
        if self.speculation is not None:
            self.speculation.retire_below(height)

    def reconstruct_last_commit(self) -> None:
        """Rebuild rs.last_commit from the stored seen commit (Go
        state.go:549), its signatures checked as one batch."""
        from ..crypto.batch import BatchVerifier

        assert self.state is not None
        seen = self.block_store.load_seen_commit(self.state.last_block_height)
        if seen is None:
            raise RuntimeError(
                f"no seen commit for height {self.state.last_block_height}"
            )
        last_precommits = VoteSet(
            self.state.chain_id, seen.height, seen.round,
            VoteType.PRECOMMIT, self.state.last_validators,
        )
        votes = []
        for idx, cs_sig in enumerate(seen.signatures):
            if cs_sig.is_absent():
                continue
            votes.append(Vote(
                type=VoteType.PRECOMMIT,
                height=seen.height,
                round=seen.round,
                block_id=cs_sig.block_id_for(seen.block_id),
                timestamp=cs_sig.timestamp,
                validator_address=cs_sig.validator_address,
                validator_index=idx,
                signature=cs_sig.signature,
            ))
        bv = BatchVerifier()
        vals = self.state.last_validators
        for v in votes:
            val = vals.get_by_index(v.validator_index)
            bv.add(val.pub_key, v.sign_bytes(self.state.chain_id), v.signature)
        _, verdicts = bv.verify()
        for v, ok in zip(votes, verdicts):
            if not ok:
                raise RuntimeError(
                    f"invalid signature in seen commit (val index "
                    f"{v.validator_index})"
                )
            last_precommits.add_vote(v, verify=False)
        if not last_precommits.has_two_thirds_majority():
            raise RuntimeError("seen commit lacks +2/3")
        self.rs.last_commit = last_precommits
        self.scheduler.last_commit = last_precommits

    # -- the serialized event loop --

    async def _receive_routine(self) -> None:
        while True:
            internal = asyncio.ensure_future(self.internal_msg_queue.get())
            peer = asyncio.ensure_future(self.peer_funnel.get())
            timeout = asyncio.ensure_future(self.ticker.queue.get())
            done, pending = await asyncio.wait(
                [internal, peer, timeout],
                return_when=asyncio.FIRST_COMPLETED,
            )
            for p in pending:
                p.cancel()
            try:
                if internal in done:
                    qm = internal.result()
                    self._wal_write_sync(MsgInfo(
                        "", m.encode_consensus_msg(qm.msg)
                    ))
                    async with self._state_mtx:
                        await self._handle_msg(qm)
                if peer in done:
                    qm = peer.result()
                    self._wal_write(MsgInfo(
                        qm.peer_id, m.encode_consensus_msg(qm.msg)
                    ))
                    async with self._state_mtx:
                        await self._handle_msg(qm)
                if timeout in done:
                    ti = timeout.result()
                    self._wal_write_sync(ti)
                    async with self._state_mtx:
                        await self._handle_timeout(ti)
            except asyncio.CancelledError:
                raise
            except BaseException:
                self.logger.exception("consensus handler failed; halting")
                raise

    def _wal_write(self, msg) -> None:
        if self.wal is not None and not self._replay_mode:
            self.wal.write(msg, _clock.time_ns())

    def _wal_write_sync(self, msg) -> None:
        if self.wal is not None and not self._replay_mode:
            self.wal.write_sync(msg, _clock.time_ns())

    async def _handle_msg(self, qm: _QueuedMsg) -> None:
        """Validation failures on a single message are logged and
        dropped — one byzantine peer must not halt the node (Go
        handleMsg logs setProposal/AddProposalBlockPart errors and
        continues). Errors inside step *transitions* propagate: those
        are local invariant violations (Go panics, a graceful halt)."""
        msg = qm.msg
        if isinstance(msg, m.ProposalMessage):
            try:
                self._set_proposal(msg.proposal)
            except UNCAUGHT:
                raise
            except Exception as e:
                self.logger.warning("rejecting proposal from %r: %s",
                                    qm.peer_id, e)
                return
            # parts may have completed before the proposal arrived
            if self.rs.proposal_complete():
                await self._proposal_completed()
        elif isinstance(msg, m.BlockPartMessage):
            try:
                added = self._add_proposal_block_part(msg)
            except UNCAUGHT:
                raise
            except Exception as e:
                self.logger.warning("rejecting block part from %r: %s",
                                    qm.peer_id, e)
                return
            if added and self.rs.step == RoundStep.COMMIT and \
                    self.rs.proposal_block is not None:
                # catchup: the block completed while waiting in commit
                # with no Proposal (Go addProposalBlockPart →
                # tryFinalizeCommit when cs.Step == RoundStepCommit)
                await self._try_finalize_commit(self.rs.height)
            elif added and self.rs.proposal_complete():
                await self._proposal_completed()
        elif isinstance(msg, m.VoteMessage):
            if (self._replay_mode or self.config.vote_batch_window_ms <= 0
                    or not self.scheduler.enqueue(msg.vote, qm.peer_id)):
                await self._try_add_vote(msg.vote, qm.peer_id)
        else:
            self.logger.warning("unknown consensus msg %r", type(msg))

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < int(rs.step)
        ):
            return  # stale
        step = RoundStep(ti.step)

        def fire(publisher_name):  # Go state.go:854-864
            if self.event_bus is not None:
                getattr(self.event_bus, publisher_name)(
                    EventDataRoundState(ti.height, ti.round, step.name))

        if step == RoundStep.NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif step == RoundStep.NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif step == RoundStep.PROPOSE:
            fire("publish_timeout_propose")
            await self._enter_prevote(ti.height, ti.round)
        elif step == RoundStep.PREVOTE_WAIT:
            fire("publish_timeout_wait")
            await self._enter_precommit(ti.height, ti.round)
        elif step == RoundStep.PRECOMMIT_WAIT:
            fire("publish_timeout_wait")
            await self._enter_precommit(ti.height, ti.round)
            await self._enter_new_round(ti.height, ti.round + 1)

    # -- step transitions --

    def _new_step(self, step: RoundStep) -> None:
        self.rs.step = step
        rsm = RoundStateMessage(self.rs.height, self.rs.round, int(step))
        self._wal_write(rsm)
        if self.event_bus is not None:
            self.event_bus.publish_new_round_step(EventDataRoundState(
                self.rs.height, self.rs.round, step.name
            ))
        self._broadcast("step", self.rs)

    async def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            return
        if round_ > rs.round and rs.validators is not None:
            # advance proposer rotation for skipped rounds
            rs.validators.increment_proposer_priority(round_ - rs.round)
        rs.round = round_
        rs.step = RoundStep.NEW_ROUND
        if round_ > 0:
            # new round: prior proposal is void
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_)
        rs.triggered_timeout_precommit = False
        if self.event_bus is not None:
            self.event_bus.publish_new_round(EventDataRoundState(
                height, round_, rs.step.name
            ))
        await self._enter_propose(height, round_)

    async def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        rs.round = round_
        self._new_step(RoundStep.PROPOSE)

        self.ticker.schedule(TimeoutInfo(
            self.config.propose_timeout(round_), height, round_,
            int(RoundStep.PROPOSE),
        ))

        mb = self.misbehaviors.get(height)
        if mb is not None and await mb.enter_propose(self, height, round_):
            return

        if self._is_proposer() and self.priv_validator is not None:
            await self._decide_proposal(height, round_)

        if rs.proposal_complete():
            await self._enter_prevote(height, round_)

    def _is_proposer(self) -> bool:
        return (
            self.priv_validator_address is not None
            and self.rs.validators is not None
            and self.rs.validators.get_proposer().address
            == self.priv_validator_address
        )

    async def _decide_proposal(self, height: int, round_: int) -> None:
        """Go defaultDecideProposal (state.go:1063)."""
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            commit = None
            if height == self.state.initial_height:
                commit = Commit(0, 0, NIL_BLOCK_ID, [])
            elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
                commit = rs.last_commit.make_commit()
            else:
                self.logger.error("cannot propose: no last commit")
                return
            block = self.block_exec.create_proposal_block(
                height, self.state, commit, self.priv_validator_address,
            )
            parts = block.make_part_set()

        block_id = BlockID(block.hash(), parts.header())
        proposal = Proposal(
            height=height, round=round_, pol_round=rs.valid_round,
            block_id=block_id, timestamp=_clock.time_ns(),
        )
        try:
            res = self.priv_validator.sign_proposal(self.state.chain_id,
                                                    proposal)
            if asyncio.iscoroutine(res):
                await res  # remote signer round-trip
        except Exception as e:
            self.logger.error("failed to sign proposal: %r", e)
            return
        self._send_internal(m.ProposalMessage(proposal))
        for i in range(parts.total):
            self._send_internal(m.BlockPartMessage(height, round_,
                                                   parts.get_part(i)))

    def _send_internal(self, msg) -> None:
        self.internal_msg_queue.put_nowait(_QueuedMsg(msg, ""))

    async def _proposal_completed(self) -> None:
        """Block fully received: react based on the current step (Go
        addProposalBlockPart, state.go:1775-1840)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        bid, has_maj = (prevotes.two_thirds_majority()
                        if prevotes is not None else (None, False))
        if has_maj and bid is not None and not bid.is_nil() and rs.valid_round < rs.round:
            if rs.proposal_block.hash() == bid.hash:
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
                if self.event_bus is not None:  # state.go:1450
                    self.event_bus.publish_valid_block(
                        EventDataRoundState(rs.height, rs.round,
                                            rs.step.name))
        if rs.step <= RoundStep.PROPOSE and rs.proposal_complete():
            await self._enter_prevote(rs.height, rs.round)
            if has_maj:
                await self._enter_precommit(rs.height, rs.round)
        elif rs.step == RoundStep.COMMIT:
            await self._try_finalize_commit(rs.height)

    async def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        self._new_step(RoundStep.PREVOTE)
        mb = self.misbehaviors.get(height)
        if mb is not None and await mb.enter_prevote(self, height, round_):
            return
        # Go defaultDoPrevote (state.go:1229)
        if rs.locked_block is not None:
            await self._sign_add_vote(VoteType.PREVOTE, rs.locked_block.hash(),
                                      rs.locked_block_parts.header())
        elif rs.proposal_block is None:
            await self._sign_add_vote(VoteType.PREVOTE, b"", None)
        else:
            try:
                await self.block_exec.validate_block_async(
                    self.state, rs.proposal_block)
                await self._sign_add_vote(
                    VoteType.PREVOTE, rs.proposal_block.hash(),
                    rs.proposal_block_parts.header(),
                )
            except UNCAUGHT:
                raise
            except Exception as e:
                self.logger.warning("invalid proposal block: %r", e)
                await self._sign_add_vote(VoteType.PREVOTE, b"", None)

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        self._new_step(RoundStep.PREVOTE_WAIT)
        self.ticker.schedule(TimeoutInfo(
            self.config.prevote_timeout(round_), height, round_,
            int(RoundStep.PREVOTE_WAIT),
        ))

    async def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        self._new_step(RoundStep.PRECOMMIT)
        mb = self.misbehaviors.get(height)
        if mb is not None and await mb.enter_precommit(self, height, round_):
            return
        prevotes = rs.votes.prevotes(round_)
        bid, has_maj = (prevotes.two_thirds_majority()
                        if prevotes is not None else (None, False))

        if not has_maj:
            # no polka: precommit nil
            await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)
            return

        if self.event_bus is not None:
            self.event_bus.publish_polka(EventDataRoundState(
                height, round_, rs.step.name
            ))

        if bid is None or bid.is_nil():
            # +2/3 prevoted nil: unlock and precommit nil (state.go:1320)
            if rs.locked_block is not None and self.event_bus is not None:
                self.event_bus.publish_unlock(EventDataRoundState(
                    height, round_, rs.step.name))
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)
            return

        # +2/3 for a block
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            rs.locked_round = round_  # re-lock at this round
            if self.event_bus is not None:  # state.go:1327
                self.event_bus.publish_relock(EventDataRoundState(
                    height, round_, rs.step.name))
            await self._sign_add_vote(VoteType.PRECOMMIT, bid.hash,
                                      bid.part_set_header)
            return
        if rs.proposal_block is not None and rs.proposal_block.hash() == bid.hash:
            try:
                await self.block_exec.validate_block_async(
                    self.state, rs.proposal_block)
            except UNCAUGHT:
                raise
            except Exception as e:
                self.logger.error("polka for invalid block: %r", e)
                await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)
                return
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            if self.event_bus is not None:
                self.event_bus.publish_lock(EventDataRoundState(
                    height, round_, rs.step.name
                ))
            await self._sign_add_vote(VoteType.PRECOMMIT, bid.hash,
                                      bid.part_set_header)
            return

        # polka for a block we don't have: unlock, precommit nil, fetch
        if rs.locked_block is not None and self.event_bus is not None:
            self.event_bus.publish_unlock(EventDataRoundState(
                height, round_, rs.step.name))  # state.go:1362
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
            bid.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(
                bid.part_set_header.total, bid.part_set_header.hash
            )
        await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        rs.triggered_timeout_precommit = True
        self.ticker.schedule(TimeoutInfo(
            self.config.precommit_timeout(round_), height, round_,
            int(RoundStep.PRECOMMIT_WAIT),
        ))

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        rs.commit_round = commit_round
        rs.commit_time = _clock.monotonic()
        self._new_step(RoundStep.COMMIT)

        precommits = rs.votes.precommits(commit_round)
        bid, ok = precommits.two_thirds_majority()
        assert ok and bid is not None and not bid.is_nil()

        # if we have the block locked, promote it to proposal slots
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        # if we don't have the full block yet, set up parts to receive it
        if rs.proposal_block is None or rs.proposal_block.hash() != bid.hash:
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                bid.part_set_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(
                    bid.part_set_header.total, bid.part_set_header.hash
                )
                # advertise which part-set we now accept so peers'
                # catchup gossip starts feeding us the block (Go
                # enterCommit → PublishEventValidBlock)
                self._broadcast("valid_block", rs)
        await self._try_finalize_commit(height)

    async def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        bid, ok = precommits.two_thirds_majority()
        if not ok or bid is None or bid.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != bid.hash:
            return  # don't have the block yet
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """Go finalizeCommit (state.go:1491). It runs from the receive
        routine or from a vote scheduler tally; a failure here halts the
        node from either."""
        try:
            await self._commit_height(height)
        except BaseException as e:
            if not isinstance(e, asyncio.CancelledError):
                self._halt(e)
            raise

    async def _commit_height(self, height: int) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(rs.commit_round)
        bid, _ = precommits.two_thirds_majority()
        block, parts = rs.proposal_block, rs.proposal_block_parts

        block.validate_basic()

        if self.block_store.height < block.header.height:
            seen_commit = precommits.make_commit()
            self.block_store.save_block(block, parts, seen_commit)

        _failpoint("consensus.commit.block_saved")

        if self.wal is not None and not self._replay_mode:
            self.wal.write_sync(EndHeightMessage(height), _clock.time_ns())

        _failpoint("consensus.commit.wal_delimited")

        state_copy = self.state.copy()
        new_state, retain_height = await self.block_exec.apply_block(
            state_copy, bid, block
        )
        if retain_height > 0:
            try:
                pruned = self.block_store.prune_blocks(retain_height)
                self.block_exec.store.prune_states(1, retain_height)
                self.logger.debug("pruned %d blocks to %d", pruned, retain_height)
            except Exception as e:
                self.logger.error("prune failed: %r", e)

        self._record_commit_metrics(block, precommits,
                                    rs.proposal_block_parts)
        self.update_to_state(new_state)
        self._height_done.set()
        self._height_done = asyncio.Event()
        self._schedule_round0()

    def _record_commit_metrics(self, block, precommits, parts=None) -> None:
        """Go consensus/metrics.go recording (state.go:1612
        recordMetrics), into METRICS."""
        met = METRICS
        met["height"] = block.header.height
        met["rounds"] = self.rs.round
        vals = self.rs.validators
        met["validators"] = len(vals)
        met["validators_power"] = vals.total_voting_power()
        missing = missing_power = 0
        for i in range(len(vals)):
            if precommits.get_by_index(i) is None:
                missing += 1
                missing_power += vals.validators[i].voting_power
        met["missing_validators"] = missing
        met["missing_validators_power"] = missing_power
        # evidence in THIS block tallies byzantine signers (set
        # unconditionally: the gauges drop back to 0 on evidence-free
        # blocks, like the reference's)
        byz = {e.vote_a.validator_address
               for e in block.evidence.evidence
               if hasattr(e, "vote_a")}
        met["byzantine_validators"] = len(byz)
        met["byzantine_validators_power"] = sum(
            v.voting_power for v in vals.validators if v.address in byz)
        if self.priv_validator_address is not None and \
                vals.has_address(self.priv_validator_address):
            idx, own = vals.get_by_address(self.priv_validator_address)
            met["validator_power"] = own.voting_power
            if precommits.get_by_index(idx) is not None:
                met["validator_last_signed_height"] = block.header.height
            else:
                met["validator_missed_blocks"] += 1
        ntx = len(block.data.txs)
        met["num_txs"] = ntx
        met["total_txs"] += ntx
        # the part set already holds the serialized size
        if parts is not None:
            met["block_size_bytes"] = parts.byte_size
        prev = self.block_store.load_block_meta(block.header.height - 1)
        if prev is not None:
            h = met["block_interval_seconds"]
            h["count"] += 1
            h["sum"] += max(block.header.time - prev.header.time, 0) / 1e9

    # -- proposals & parts --

    def _set_proposal(self, proposal: Proposal) -> None:
        """Go defaultSetProposal (state.go:1719)."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        proposal.validate_basic()
        if proposal.pol_round != -1 and not (
            0 <= proposal.pol_round < proposal.round
        ):
            raise VoteSetError("invalid POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            raise VoteSetError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header.total,
                proposal.block_id.part_set_header.hash,
            )
        if self.speculation is not None:
            # the precommit sign-byte template for this height is now
            # fully determined — start the verify-ahead pipeline
            self.speculation.begin_height(
                self.state.chain_id, rs.validators, rs.height,
                proposal.round, proposal.block_id)
        self._broadcast("proposal", proposal)

    def _add_proposal_block_part(self, msg: m.BlockPartMessage) -> bool:
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if added:
            METRICS["block_parts"] += 1
        if added and rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            block = Block.from_bytes(data)
            # The part-set header (each part merkle-proven into it) is
            # the authoritative identity of what we accepted. Compare
            # against the proposal only when the proposal refers to THIS
            # part set: during commit-time catch-up the parts carry the
            # DECIDED block, which legitimately differs from a stale
            # earlier-round proposal.
            if (rs.proposal is not None and
                    rs.proposal_block_parts.has_header(
                        rs.proposal.block_id.part_set_header) and
                    block.hash() != rs.proposal.block_id.hash):
                raise VoteSetError(
                    "completed block hash != proposal block id")
            rs.proposal_block = block
            if self.event_bus is not None:
                self.event_bus.publish_complete_proposal(EventDataRoundState(
                    rs.height, rs.round, "CompleteProposal"
                ))
            self._broadcast("block_part", msg)
        elif added:
            self._broadcast("block_part", msg)
        return added

    # -- votes --

    async def _tally(self, vote: Vote, peer_id: str, preverified: bool) -> None:
        """VoteScheduler's tally step: one vote under the state mutex."""
        async with self._state_mtx:
            await self._try_add_vote(vote, peer_id, preverified=preverified)

    async def _try_add_vote(self, vote: Vote, peer_id: str,
                            preverified: bool = False) -> bool:
        """Go tryAddVote (state.go:1845): conflicting votes become
        evidence; late precommits for the last height extend
        rs.last_commit."""
        try:
            return await self._add_vote(vote, peer_id, preverified)
        except ConflictingVoteError as e:
            if self.priv_validator_address == vote.validator_address:
                self.logger.error(
                    "found conflicting vote from ourselves; height %d",
                    vote.height,
                )
                return False
            if self.evpool is not None and e.existing is not None:
                from ..state import median_time
                from ..types.evidence import DuplicateVoteEvidence

                # The evidence timestamp must equal the header time of
                # the block at the EVIDENCE height (Go state.go:1868-76
                # uses the LastCommit median; the late-vote case, a
                # conflicting vote for the already-committed height,
                # takes that block's time, state.last_block_time).
                if vote.height == self.state.last_block_height or \
                        self.rs.last_commit is None:
                    ts = self.state.last_block_time
                    vals = self.rs.last_validators
                else:
                    ts = median_time(self.rs.last_commit.make_commit(),
                                     self.rs.last_validators)
                    vals = self.rs.validators
                ev = DuplicateVoteEvidence.from_votes(
                    e.existing, vote, ts, vals,
                )
                self.evpool.add_evidence_from_consensus(ev)
            return False
        except VoteSetError as e:
            self.logger.debug("vote rejected: %s", e)
            return False

    async def _add_vote(self, vote: Vote, peer_id: str,
                        preverified: bool = False) -> bool:
        rs = self.rs
        verify = not preverified
        # late precommit for the previous height (state.go:1901)
        if vote.height + 1 == rs.height and vote.type == VoteType.PRECOMMIT:
            if rs.step != RoundStep.NEW_HEIGHT or rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote, verify=verify)
            if added:
                if self.speculation is not None:
                    # the plane keeps height - 1 until the next commit:
                    # a late lane patched now serves the LastCommit our
                    # own proposal carries (the reference feeds only the
                    # current height's precommits)
                    self.speculation.observe_precommit(vote)
                self._publish_vote(vote)
            return added
        if vote.height != rs.height:
            return False

        added = rs.votes.add_vote(vote, peer_id, verify=verify)
        if not added:
            return False
        if self.speculation is not None and \
                vote.type == VoteType.PRECOMMIT:
            # patch the verify-ahead lane (conflicting/nil votes are
            # handled inside: they poison the lane, never serve)
            self.speculation.observe_precommit(vote)
        self._publish_vote(vote)
        self._broadcast("has_vote", m.HasVoteMessage(
            vote.height, vote.round, int(vote.type), vote.validator_index
        ))

        if vote.type == VoteType.PREVOTE:
            await self._on_prevote_added(vote)
        else:
            await self._on_precommit_added(vote)
        return True

    def _publish_vote(self, vote: Vote) -> None:
        if self.event_bus is not None:
            self.event_bus.publish_vote(EventDataVote(vote))
        self._broadcast("vote", vote)

    async def _on_prevote_added(self, vote: Vote) -> None:
        """Go addVote prevote handling (state.go:1950-2032)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        bid, has_maj = prevotes.two_thirds_majority()

        if has_maj and bid is not None and not bid.is_nil():
            # unlock if a later polka contradicts our lock (state.go:1965)
            if (rs.locked_block is not None
                    and rs.locked_round < vote.round <= rs.round
                    and rs.locked_block.hash() != bid.hash):
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
                if self.event_bus is not None:  # state.go:1987
                    self.event_bus.publish_unlock(EventDataRoundState(
                        rs.height, rs.round, rs.step.name))
            # track valid block (state.go:1984)
            if rs.valid_round < vote.round <= rs.round:
                if rs.proposal_block is not None and rs.proposal_block.hash() == bid.hash:
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                    if self.event_bus is not None:  # state.go:2013
                        self.event_bus.publish_valid_block(
                            EventDataRoundState(rs.height, rs.round,
                                                rs.step.name))
                elif rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    bid.part_set_header
                ):
                    # polka for a block we don't have: start fetching it
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(
                        bid.part_set_header.total, bid.part_set_header.hash
                    )

        if rs.round < vote.round and prevotes.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote.round)
        elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
            if has_maj and (rs.proposal_complete() or bid is None or bid.is_nil()):
                await self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any() and rs.step == RoundStep.PREVOTE:
                await self._enter_prevote_wait(rs.height, vote.round)
        elif (rs.proposal is not None
              and 0 <= rs.proposal.pol_round == vote.round
              and rs.step == RoundStep.PROPOSE
              and rs.proposal_complete()):
            await self._enter_prevote(rs.height, rs.round)

    async def _on_precommit_added(self, vote: Vote) -> None:
        """Go addVote precommit handling (state.go:2034-2067)."""
        rs = self.rs
        precommits = rs.votes.precommits(vote.round)
        bid, has_maj = precommits.two_thirds_majority()
        if has_maj:
            if bid is None or bid.is_nil():
                # +2/3 precommitted nil: straight to the next round
                await self._enter_new_round(rs.height, vote.round + 1)
            else:
                await self._enter_new_round(rs.height, vote.round)
                await self._enter_precommit(rs.height, vote.round)
                await self._enter_commit(rs.height, vote.round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    await self._enter_new_round(self.rs.height, 0)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote.round)
            await self._enter_precommit_wait(rs.height, vote.round)

    async def _sign_add_vote(self, type_: VoteType, hash_: bytes,
                             part_set_header) -> Vote | None:
        """Go signAddVote (state.go:2139)."""
        if self.priv_validator is None or self.rs.validators is None:
            return None
        if not self.rs.validators.has_address(self.priv_validator_address):
            return None
        idx, _ = self.rs.validators.get_by_address(self.priv_validator_address)
        block_id = (
            BlockID(hash_, part_set_header) if hash_ else None
        )
        vote = Vote(
            type=type_,
            height=self.rs.height,
            round=self.rs.round,
            block_id=block_id,
            timestamp=self._vote_time(),
            validator_address=self.priv_validator_address,
            validator_index=idx,
        )
        try:
            res = self.priv_validator.sign_vote(self.state.chain_id, vote)
            if asyncio.iscoroutine(res):
                await res  # remote signer round-trip
        except Exception as e:
            self.logger.error("failed to sign vote: %r", e)
            return None
        self._send_internal(m.VoteMessage(vote))
        return vote

    def _vote_time(self) -> int:
        """now, but strictly after the block we're voting on (Go
        voteTime, state.go:2120)."""
        now = _clock.time_ns()
        time_iota = max(
            self.state.consensus_params.block.time_iota_ms, 1
        ) * 1_000_000
        min_time = 0
        if self.rs.locked_block is not None:
            min_time = self.rs.locked_block.header.time + time_iota
        elif self.rs.proposal_block is not None:
            min_time = self.rs.proposal_block.header.time + time_iota
        return max(now, min_time)

    # -- WAL catchup replay (Go consensus/replay.go:94) --

    async def _catchup_replay(self) -> None:
        assert self.wal is not None
        self.wal.repair()
        height = self.state.last_block_height
        msgs, found = self.wal.search_for_end_height(height)
        if not found and height > 0:
            return  # nothing in-flight
        self._replay_mode = True
        try:
            for tm in msgs:
                inner = tm.msg
                if isinstance(inner, EndHeightMessage):
                    break
                if isinstance(inner, MsgInfo):
                    try:
                        cmsg = m.decode_consensus_msg(inner.msg_bytes)
                    except ValueError:
                        continue
                    await self._handle_msg(_QueuedMsg(cmsg, inner.peer_id))
                # TimeoutInfo: timeouts are re-derived live, not replayed
        finally:
            self._replay_mode = False
        self.logger.info("replayed %d WAL messages for height %d",
                         len(msgs), self.rs.height)

    # -- public API (reactor / rpc) --

    def _funnel_class(self, msg) -> bool:
        """True = high class (round-critical: votes, proposals); False =
        low class (bulk data that is re-gossiped on demand and may be
        shed under flood)."""
        return isinstance(msg, (m.VoteMessage, m.ProposalMessage))

    def _shed_duplicate_vote(self, msg) -> bool:
        """Under funnel pressure, a vote already tallied is the first
        thing to shed. Only consulted once the funnel is half full."""
        if not isinstance(msg, m.VoteMessage) or \
                not self.peer_funnel.pressured():
            return False
        vs = self.scheduler.target_vote_set(msg.vote)
        if vs is not None and vs.is_duplicate(msg.vote):
            # advisory: losing an already-tallied duplicate is not
            # information loss, so it does not drive the level
            CONTROLLER.shed("consensus.funnel.votes", advisory=True)
            return True
        return False

    async def add_peer_msg(self, msg, peer_id: str) -> None:
        """Priority-aware admission into the bounded funnel. The high
        class blocks when full (backpressure onto the calling peer's
        recv loop, the Go reference's `cs.peerMsgQueue <- msgInfo`,
        state.go:456); the low class sheds when full."""
        qm = _QueuedMsg(msg, peer_id)
        if self._funnel_class(msg):
            if self._shed_duplicate_vote(msg):
                return
            await self.peer_funnel.put_high(qm)
        else:
            self.peer_funnel.put_low(qm)

    def add_peer_msg_nowait(self, msg, peer_id: str) -> None:
        """Non-blocking variant for sync call sites; raises QueueFull
        for the high class instead of applying backpressure (the low
        class sheds, as in add_peer_msg)."""
        qm = _QueuedMsg(msg, peer_id)
        if self._funnel_class(msg):
            if self._shed_duplicate_vote(msg):
                return
            self.peer_funnel.put_high_nowait(qm)
        else:
            self.peer_funnel.put_low(qm)

    def get_round_state(self) -> RoundState:
        return self.rs

    async def wait_for_height(self, height: int, timeout: float = 60.0) -> None:
        """Return once `height` is committed; re-raise what halted the
        node."""
        deadline = _clock.monotonic() + timeout
        while self.rs.height <= height:
            if self.fault is not None:
                raise self.fault
            remaining = deadline - _clock.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"height {height} not reached (at {self.rs.height})"
                )
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._height_done.wait()), remaining
                )
            except asyncio.TimeoutError:
                if self.fault is not None:
                    raise self.fault
                raise TimeoutError(
                    f"height {height} not reached (at {self.rs.height})"
                )
