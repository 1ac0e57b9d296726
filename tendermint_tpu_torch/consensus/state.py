"""The consensus vote micro-batch scheduler (reference:
consensus/state.py, ConsensusState._enqueue_vote to
_verify_and_commit_batch, :917-1170).

Votes are not verified one at a time under the VoteSet lock (Go
reference vote_set.go:203): they accumulate for vote_batch_window_ms
(or until vote_batch_max) and verify as ONE device batch in a worker
thread, then commit through the state machine's tally step with the
signature already checked. Duplicate/conflict semantics are preserved
because VoteSet.add_vote re-runs every non-signature check at commit
time; the pubkey each lane was verified against is resolved per
(height, index), and a height's validator mapping never changes, so a
vote cannot be committed against a different key than it was verified
with.

The reference keeps this state on ConsensusState; here VoteScheduler
owns it (the buffer, the pending event, the config, the current
height's HeightVoteSet and last commit with their valsets, the per-peer
feedback) and takes the tally step as a callable, ConsensusState.
_try_add_vote in the reference. ``batch_verdicts`` is the reference's
_batch_verdicts, which never reads its ConsensusState. ConsensusState
itself, the CONSENSUS_VOTE_BATCH span and the consensus metrics come
with later slices.

One divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError from a batch is not degraded
to the host path; it ends the scheduler's task, whose result re-raises
it.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from ..config import ConsensusConfig
from ..crypto.batch import UNCAUGHT
from ..libs.overload import CONTROLLER
from ..types.vote import Vote, VoteType

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
        task, self.task = self.task, None
        if task is not None:
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
            try:
                await self._tally(vote, peer_id, True)
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
