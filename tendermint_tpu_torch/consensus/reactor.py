"""Consensus reactor: gossips round state, proposals, block parts and
votes between peers (reference: consensus/reactor.py; Go
consensus/reactor.go:27-30, the four
channels 0x20-0x23; gossipDataRoutine :492, gossipVotesRoutine :632,
queryMaj23Routine :765; PeerState :932).

Redesign notes (asyncio, not goroutines): each peer gets three
supervised tasks (data / votes / maj23) started on add_peer and
cancelled on remove_peer. Outbound state changes arrive via
ConsensusState.broadcast_hooks — a synchronous fan-out the reactor
turns into non-blocking `Switch.broadcast` calls — rather than the
reference's internal event switch. All inbound consensus messages are
funneled into the consensus state's single serialized receive queue
(`add_peer_msg`), preserving the reference's one-event-loop invariant.

Lifecycle messages carry the origin tag (libs/tracing.py, field 15):
the span id live at send time (0 with none, as in the reference), and
the label ``trace_node`` (the ConsensusState's, which the node sets to
its moniker) or the first 16 characters of the node id. The receiver
folds a received tag into its live ``p2p.recv_msg`` span.

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a gossip routine that meets a KernelError or NoDeviceError
halts the node (``Reactor.halt``: the Switch stops and the
ConsensusState halts, so wait_for_height re-raises it) instead of
dying with a logged traceback and starving that peer.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto.batch import UNCAUGHT
from ..libs import clock, tracing
from ..libs.bits import BitArray
from ..p2p.conn.connection import ChannelDescriptor
from ..p2p.switch import Reactor
from ..types.block import NIL_BLOCK_ID, PartSetHeader
from ..types.vote import VoteType
from . import messages as m
from .cstypes import RoundState, RoundStep
from .state import ConsensusState

logger = logging.getLogger("consensus.reactor")

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

PEER_GOSSIP_SLEEP = 0.1   # reference: peerGossipSleepDuration (100ms)
PEER_QUERY_MAJ23_SLEEP = 2.0  # reference: peerQueryMaj23SleepDuration

# Rounds of vote bit-arrays retained per peer; a byzantine peer spinning
# rounds must not grow our bookkeeping without bound.
_MAX_TRACKED_ROUNDS = 64


class PeerState:
    """What we know about one peer's view of consensus
    (reference: consensus/reactor.go:932 PeerState + PeerRoundState)."""

    def __init__(self, peer):
        self.peer = peer
        self.height = 0
        self.round = -1
        self.step = RoundStep.NEW_HEIGHT
        self.start_time = 0.0
        self.proposal = False
        self.proposal_block_parts_header: PartSetHeader | None = None
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.prevotes: dict[int, BitArray] = {}
        self.precommits: dict[int, BitArray] = {}
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: BitArray | None = None
        # stats (reference PeerState.Stats → MarkPeerAsGood)
        self.votes_received = 0
        self.block_parts_received = 0

    # -- bit-array bookkeeping --

    def _ensure(self, d: dict[int, BitArray], round_: int, n: int) -> BitArray:
        ba = d.get(round_)
        if ba is None or ba.size != n:
            ba = BitArray(n)
            d[round_] = ba
            while len(d) > _MAX_TRACKED_ROUNDS:
                del d[min(d)]
        return ba

    def get_vote_bits(self, height: int, round_: int,
                      type_: int) -> BitArray | None:
        """reference: PeerState.getVoteBitArray."""
        if self.height == height:
            if type_ == VoteType.PREVOTE:
                if round_ == self.proposal_pol_round and \
                        self.proposal_pol is not None:
                    return self.proposal_pol
                return self.prevotes.get(round_)
            if round_ == self.catchup_commit_round and \
                    self.catchup_commit is not None:
                return self.catchup_commit
            return self.precommits.get(round_)
        if self.height == height + 1 and type_ == VoteType.PRECOMMIT \
                and round_ == self.last_commit_round:
            return self.last_commit
        return None

    def ensure_vote_bits(self, height: int, round_: int, type_: int,
                         num_validators: int) -> BitArray | None:
        if self.height != height:
            return self.get_vote_bits(height, round_, type_)
        d = self.prevotes if type_ == VoteType.PREVOTE else self.precommits
        self._ensure(d, round_, num_validators)
        return self.get_vote_bits(height, round_, type_)

    def set_has_vote(self, height: int, round_: int, type_: int,
                     index: int, num_validators: int = 0) -> None:
        bits = self.ensure_vote_bits(height, round_, type_,
                                     num_validators) if num_validators \
            else self.get_vote_bits(height, round_, type_)
        if bits is not None and 0 <= index < bits.size:
            bits.set(index, True)

    def set_has_part(self, height: int, round_: int, index: int) -> None:
        if self.height == height and self.round == round_ and \
                self.proposal_block_parts is not None and \
                0 <= index < self.proposal_block_parts.size:
            self.proposal_block_parts.set(index, True)

    # -- message application (all reference Apply*Message methods) --

    def apply_new_round_step(self, msg: m.NewRoundStepMessage) -> None:
        ph, pr = self.height, self.round
        if msg.height < ph or (msg.height == ph and msg.round < pr):
            return  # stale
        self.height = msg.height
        self.round = msg.round
        self.step = RoundStep(msg.step)
        self.start_time = clock.monotonic() - msg.seconds_since_start_time
        if ph != msg.height or pr != msg.round:
            self.proposal = False
            self.proposal_block_parts_header = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
        if ph != msg.height:
            # Their precommits for the previous height become last-commit
            # (reference ApplyNewRoundStepMessage).
            if ph + 1 == msg.height and pr == msg.last_commit_round:
                self.last_commit = self.precommits.get(pr)
            else:
                self.last_commit = None
            self.last_commit_round = msg.last_commit_round
            self.prevotes = {}
            self.precommits = {}
            self.catchup_commit_round = -1
            self.catchup_commit = None

    def apply_new_valid_block(self, msg: m.NewValidBlockMessage) -> None:
        if self.height != msg.height:
            return
        if self.round != msg.round and not msg.is_commit:
            return
        # REPLACE, not OR: the sender's advert is its true holdings,
        # and our marks include optimistic send-time marks that may be
        # wrong (parts sent against a header it since replaced). An OR
        # would preserve exactly the stale marks the periodic
        # commit-advert exists to heal; the cost — re-sending a few
        # in-flight parts after each advert — is bounded and ends at
        # block completion.
        self.proposal_block_parts_header = msg.block_parts_header
        self.proposal_block_parts = msg.block_parts

    def set_proposal(self, proposal) -> None:
        if self.height != proposal.height or self.round != proposal.round:
            return
        if self.proposal:
            return
        self.proposal = True
        if self.proposal_block_parts is not None:
            return  # already set via NewValidBlock
        self.proposal_pol_round = proposal.pol_round
        self.proposal_pol = None  # filled by ProposalPOLMessage

    def set_proposal_parts_header(self, header: PartSetHeader) -> None:
        if self.proposal_block_parts is None:
            self.proposal_block_parts_header = header
            self.proposal_block_parts = BitArray(header.total)

    def apply_proposal_pol(self, msg: m.ProposalPOLMessage) -> None:
        if self.height != msg.height:
            return
        if self.proposal_pol_round != msg.proposal_pol_round:
            return
        self.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg: m.HasVoteMessage) -> None:
        if self.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def apply_vote_set_bits(self, msg: m.VoteSetBitsMessage,
                            our_votes: BitArray | None) -> None:
        """reference: ApplyVoteSetBitsMessage (reactor.go:1362) — the
        peer's SELF-REPORT replaces our bookkeeping for the reported
        block's votes (bits outside our tally for that block are kept).
        Replacement, not OR, is load-bearing: gossip optimistically
        marks votes as delivered on send, and a vote sent while the
        peer was still in wait_sync is dropped on its floor — an OR
        could never clear the stale mark and the peer would be starved
        of those votes forever (observed deadlocking a restarted node
        at the prevote step)."""
        bits = self.get_vote_bits(msg.height, msg.round, msg.type)
        if bits is None or msg.votes.size != bits.size:
            return
        if our_votes is not None and our_votes.size == bits.size:
            other = bits.sub(our_votes)
            new_bits = other.or_(msg.votes)
        else:
            new_bits = msg.votes  # conservative overwrite
        d = self.prevotes if msg.type == VoteType.PREVOTE \
            else self.precommits
        if msg.height == self.height and msg.round in d:
            d[msg.round] = new_bits

    def ensure_catchup_commit(self, height: int, round_: int,
                              num_validators: int) -> None:
        """reference: PeerState.EnsureCatchupCommitRound."""
        if self.height != height or self.catchup_commit_round == round_:
            return
        self.catchup_commit_round = round_
        if round_ == self.round:
            self.catchup_commit = self.precommits.get(round_)
        else:
            self.catchup_commit = BitArray(num_validators)

    def __repr__(self) -> str:
        return (f"PeerState({self.peer.id[:8]} h={self.height} "
                f"r={self.round} s={self.step.name})")


def _new_valid_block_msg(rs: RoundState, parts,
                         is_commit: bool) -> m.NewValidBlockMessage:
    return m.NewValidBlockMessage(
        height=rs.height, round=rs.round,
        block_parts_header=parts.header(),
        block_parts=parts.parts_bitarray,
        is_commit=is_commit)


def _new_round_step_msg(rs: RoundState) -> m.NewRoundStepMessage:
    lcr = rs.last_commit.round if rs.last_commit is not None else -1
    return m.NewRoundStepMessage(
        height=rs.height, round=rs.round, step=int(rs.step),
        seconds_since_start_time=max(0, int(clock.monotonic() -
                                            rs.start_time)),
        last_commit_round=lcr)


class ConsensusReactor(Reactor):
    """reference: consensus/reactor.go ConsensusReactor."""

    def __init__(self, cs: ConsensusState, wait_sync: bool = False,
                 gossip_sleep: float = PEER_GOSSIP_SLEEP):
        super().__init__("consensus")
        self.cs = cs
        self.wait_sync = wait_sync
        self.gossip_sleep = gossip_sleep
        self.peer_states: dict[str, PeerState] = {}
        self._peer_tasks: dict[str, list[asyncio.Task]] = {}
        cs.broadcast_hooks.append(self._on_cs_event)
        # Lets the state machine feed verified/rejected vote counts
        # into the trust metric (behaviour.SwitchReporter) without
        # knowing about the p2p layer.
        cs.reporter_fn = lambda: getattr(self.switch, "reporter", None)

    # -- origin stamping (height forensics) --

    def _origin_label(self) -> str:
        """Node label carried on outgoing lifecycle messages: the
        cs.trace_node the node sets, falling back to our p2p node id."""
        label = getattr(self.cs, "trace_node", "")
        if label:
            return label
        sw = self.switch
        ni = getattr(sw, "node_info_fn", None) if sw is not None else None
        try:
            return ni().node_id[:16] if ni is not None else ""
        except Exception:
            return ""

    def _stamped(self, msg) -> bytes:
        """Encode a lifecycle message (Proposal/BlockPart/Vote) with a
        cross-node origin tag (libs/tracing.py). All reactor sends of
        the three lifecycle types go through here. Non-lifecycle
        messages pass through unstamped."""
        if isinstance(msg, m.VoteMessage):
            msg.origin = tracing.origin_stamp(
                self._origin_label(), msg.vote.height, msg.vote.round)
        elif isinstance(msg, m.ProposalMessage):
            msg.origin = tracing.origin_stamp(
                self._origin_label(), msg.proposal.height,
                msg.proposal.round)
        elif isinstance(msg, m.BlockPartMessage):
            msg.origin = tracing.origin_stamp(
                self._origin_label(), msg.height, msg.round)
        return m.encode_consensus_msg(msg)

    def get_channels(self) -> list[ChannelDescriptor]:
        # priorities/capacities follow reference reactor.go GetChannels
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=6,
                              send_queue_capacity=100, name="state"),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10,
                              send_queue_capacity=100, name="data"),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=7,
                              send_queue_capacity=100, name="vote"),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2, name="votebits"),
        ]

    # -- lifecycle --

    async def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Fast-sync → consensus handoff (reference: SwitchToConsensus,
        reactor.go:106 — reconstructLastCommit THEN updateToState +
        start gossip for existing peers)."""
        self.cs.update_to_state(state)
        if state.last_block_height > 0:
            # Without this a fast-synced node that becomes proposer
            # cannot build a block ("cannot propose: no last commit")
            # and a 1/3-power set of such nodes halts the net.
            self.cs.reconstruct_last_commit()
        self.wait_sync = False
        await self.cs.start()
        for pid, ps in self.peer_states.items():
            if pid not in self._peer_tasks:
                self._start_gossip(ps)

    async def stop(self) -> None:
        for tasks in self._peer_tasks.values():
            for t in tasks:
                t.cancel()
        self._peer_tasks.clear()

    def on_halt(self, exc: BaseException) -> None:
        """The node halts on a port fault: so does consensus."""
        self.cs._halt(exc)

    # -- peer lifecycle --

    async def add_peer(self, peer) -> None:
        ps = PeerState(peer)
        self.peer_states[peer.id] = ps
        # other reactors (evidence, mempool) read the peer's consensus
        # height from here (reference: types.PeerStateKey on peer kv)
        peer.set("consensus_peer_state", ps)
        # Tell the new peer where we are (reference AddPeer: it sends
        # NewRoundStep ONLY when !WaitSync, reactor.go:199). While
        # fast/state sync runs, this reactor DROPS incoming consensus
        # messages — advertising a (height, round) here would invite
        # peers to firehose votes into that drop window and mark them
        # delivered, permanently starving us of them after the switch
        # (observed deadlocking a restarted node, and with it the net).
        # Peers learn our real position from the step broadcasts that
        # fire when consensus starts.
        if not self.wait_sync:
            peer.try_send(STATE_CHANNEL, m.encode_consensus_msg(
                _new_round_step_msg(self.cs.rs)))
            self._start_gossip(ps)

    def _start_gossip(self, ps: PeerState) -> None:
        loop = asyncio.get_running_loop()
        tasks = [
            loop.create_task(self._gossip_data_routine(ps),
                             name=f"gossip-data-{ps.peer.id[:8]}"),
            loop.create_task(self._gossip_votes_routine(ps),
                             name=f"gossip-votes-{ps.peer.id[:8]}"),
            loop.create_task(self._query_maj23_routine(ps),
                             name=f"maj23-{ps.peer.id[:8]}"),
        ]
        self._peer_tasks[ps.peer.id] = tasks

    async def remove_peer(self, peer, reason) -> None:
        for t in self._peer_tasks.pop(peer.id, []):
            t.cancel()
        self.peer_states.pop(peer.id, None)

    # -- inbound --

    async def receive(self, chan_id: int, peer, msgb: bytes) -> None:
        msg = m.decode_consensus_msg(msgb)
        # origin rehydration: the connection's recv routine runs us
        # inside a live p2p.recv_msg span — fold the sender's tag (node,
        # height, round, send-side span id) into its attrs
        origin = getattr(msg, "origin", None)
        if origin is not None:
            tracing.rehydrate_origin(origin)
        ps = self.peer_states.get(peer.id)
        if ps is None:
            return
        if chan_id == STATE_CHANNEL:
            if isinstance(msg, m.NewRoundStepMessage):
                if msg.height < 1 or msg.round < 0 or \
                        not 1 <= msg.step <= 8:
                    raise ValueError("invalid NewRoundStep")
                ps.apply_new_round_step(msg)
            elif isinstance(msg, m.NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, m.HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, m.VoteSetMaj23Message):
                await self._handle_maj23(ps, peer, msg)
            else:
                raise ValueError(f"bad msg on state channel: {type(msg)}")
        elif chan_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, m.ProposalMessage):
                ps.set_proposal(msg.proposal)
                await self.cs.add_peer_msg(msg, peer.id)
            elif isinstance(msg, m.ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, m.BlockPartMessage):
                ps.set_has_part(msg.height, msg.round, msg.part.index)
                ps.block_parts_received += 1
                await self.cs.add_peer_msg(msg, peer.id)
            else:
                raise ValueError(f"bad msg on data channel: {type(msg)}")
        elif chan_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, m.VoteMessage):
                v = msg.vote
                n = len(self.cs.rs.validators) if self.cs.rs.validators \
                    else 0
                ps.ensure_vote_bits(v.height, v.round, int(v.type), n)
                ps.set_has_vote(v.height, v.round, int(v.type),
                                v.validator_index)
                ps.votes_received += 1
                await self.cs.add_peer_msg(msg, peer.id)
                # NOTE: no trust credit here — votes are credited (or
                # debited) by the state machine AFTER signature
                # verification (state.py _verify_and_commit_batch);
                # crediting decodable-but-unverified votes would let a
                # byzantine peer farm reputation with garbage.
            else:
                raise ValueError(f"bad msg on vote channel: {type(msg)}")
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, m.VoteSetBitsMessage):
                rs = self.cs.rs
                ours = None
                if rs.height == msg.height and rs.votes is not None:
                    vs = (rs.votes.prevotes(msg.round)
                          if msg.type == VoteType.PREVOTE
                          else rs.votes.precommits(msg.round))
                    if vs is not None:
                        ours = vs.bit_array_by_block_id(None) \
                            if msg.block_id is None or msg.block_id.is_nil() \
                            else vs.bit_array_by_block_id(msg.block_id)
                logger.debug("bits from %s h=%d r=%d t=%d: %s (ours %s)",
                             peer.id[:8], msg.height, msg.round,
                             msg.type, msg.votes, ours)
                ps.apply_vote_set_bits(msg, ours)
            else:
                raise ValueError(
                    f"bad msg on votebits channel: {type(msg)}")

    async def _handle_maj23(self, ps: PeerState, peer,
                            msg: m.VoteSetMaj23Message) -> None:
        """Peer claims +2/3 at (height, round, type, block_id): record it
        and reply with which of those votes we already have
        (reference reactor.go Receive StateChannel VoteSetMaj23)."""
        rs = self.cs.rs
        if rs.height != msg.height or rs.votes is None:
            return
        if not VoteType.is_valid(msg.type):
            raise ValueError("invalid vote type in maj23")
        rs.votes.set_peer_maj23(msg.round, VoteType(msg.type), peer.id,
                                msg.block_id)
        vs = (rs.votes.prevotes(msg.round) if msg.type == VoteType.PREVOTE
              else rs.votes.precommits(msg.round))
        our_bits = vs.bit_array_by_block_id(msg.block_id) if vs else None
        if our_bits is None:
            our_bits = BitArray(len(rs.validators) if rs.validators else 0)
        logger.debug("maj23 from %s h=%d r=%d t=%d; replying bits %s",
                     peer.id[:8], msg.height, msg.round, msg.type,
                     our_bits)
        await peer.send(VOTE_SET_BITS_CHANNEL, m.encode_consensus_msg(
            m.VoteSetBitsMessage(height=msg.height, round=msg.round,
                                 type=msg.type, block_id=msg.block_id,
                                 votes=our_bits)))

    # -- outbound broadcast (ConsensusState hooks) --

    def _on_cs_event(self, event: str, payload) -> None:
        if self.switch is None:
            return
        if event == "step":
            rs: RoundState = payload
            self.switch.broadcast(STATE_CHANNEL, m.encode_consensus_msg(
                _new_round_step_msg(rs)))
            if rs.valid_block is not None and \
                    rs.valid_block_parts is not None:
                self.switch.broadcast(
                    STATE_CHANNEL,
                    m.encode_consensus_msg(_new_valid_block_msg(
                        rs, rs.valid_block_parts,
                        is_commit=rs.step == RoundStep.COMMIT)))
        elif event == "valid_block":
            rs = payload
            if rs.proposal_block_parts is not None:
                self.switch.broadcast(
                    STATE_CHANNEL,
                    m.encode_consensus_msg(_new_valid_block_msg(
                        rs, rs.proposal_block_parts,
                        is_commit=rs.step == RoundStep.COMMIT)))
        elif event == "has_vote":
            self.switch.broadcast(STATE_CHANNEL,
                                  m.encode_consensus_msg(payload))
        elif event == "vote_split":
            # Maverick equivocation (consensus/misbehavior.py): every
            # peer receives BOTH conflicting votes, in alternating
            # order. (Sending each half to half the peers — the
            # reference maverick's split — makes evidence creation a
            # race against the commit: prevotes stop being gossiped
            # once the height advances. Delivering both directly makes
            # the conflict, and thus DuplicateVoteEvidence, determinate
            # while still exercising the same add-vote conflict path.)
            vote_a, vote_b = payload
            for i, peer in enumerate(list(self.switch.peers.values())):
                pair = (vote_a, vote_b) if i % 2 == 0 else (vote_b, vote_a)
                for msg in pair:
                    peer.try_send(VOTE_CHANNEL, self._stamped(msg))
        elif event == "proposal_split":
            # Maverick double-proposal: odd peers get the alternate
            # proposal + its parts directly (even peers see the primary
            # through normal gossip).
            (_, _), (prop_b, parts_b) = payload
            for i, peer in enumerate(list(self.switch.peers.values())):
                if i % 2 == 0:
                    continue
                peer.try_send(DATA_CHANNEL,
                              self._stamped(m.ProposalMessage(prop_b)))
                for j in range(parts_b.total):
                    peer.try_send(DATA_CHANNEL, self._stamped(
                        m.BlockPartMessage(prop_b.height, prop_b.round,
                                           parts_b.get_part(j))))

    # -- gossip routines --

    async def _gossip_data_routine(self, ps: PeerState) -> None:
        """reference: gossipDataRoutine (reactor.go:492)."""
        peer = ps.peer
        last_advert = 0.0
        try:
            while True:
                rs = self.cs.rs
                # 0) WE are stuck in COMMIT missing the decided block:
                # remind this peer which part set we accept. The
                # one-shot valid_block broadcast from _enter_commit is
                # best-effort (peers may not even be connected yet at
                # net start), and peers gate their catch-up gossip on
                # having seen it — a lost advert wedged a node at its
                # commit height FOREVER while the net raced ahead
                # (found by the 120-run double-propose stress).
                if rs.step == RoundStep.COMMIT and \
                        rs.proposal_block is None and \
                        rs.proposal_block_parts is not None and \
                        clock.monotonic() - last_advert > 1.0:
                    last_advert = clock.monotonic()
                    await peer.send(
                        STATE_CHANNEL,
                        m.encode_consensus_msg(_new_valid_block_msg(
                            rs, rs.proposal_block_parts,
                            is_commit=True)))
                # demoted slow peer (switch slow-peer escalation): its
                # send queue cannot absorb bulk data — pause block-part
                # and catchup gossip (steps 1-3) until it drains. The
                # tiny state-class advert ABOVE stays exempt: skipping
                # it would re-open the wedged-at-COMMIT-forever hole
                # the periodic re-advert exists to close. Votes/state
                # routines keep serving the peer throughout.
                if getattr(peer, "slow_level", 0) >= 2:
                    await asyncio.sleep(self.gossip_sleep)
                    continue
                # 1) send a proposal block part the peer lacks
                if rs.height == ps.height and rs.round == ps.round and \
                        rs.proposal_block_parts is not None and \
                        ps.proposal_block_parts is not None and \
                        rs.proposal_block_parts.has_header(
                            ps.proposal_block_parts_header):
                    if await self._send_missing_part(
                            ps, rs.proposal_block_parts, rs.height,
                            rs.round):
                        continue
                # 2) peer is behind: feed it parts of committed blocks
                if ps.height != 0 and rs.height > ps.height:
                    if await self._gossip_catchup_part(ps):
                        continue
                # 3) send the proposal itself (+POL). SNAPSHOT the
                # proposal/parts/votes: the `await peer.send` yields to
                # the event loop, and a round change can null
                # rs.proposal mid-iteration (observed crashing this
                # routine under a maverick double-proposal — a dead
                # gossip routine silently starves the peer).
                proposal = rs.proposal
                parts = rs.proposal_block_parts
                votes = rs.votes
                # Round must match set_proposal's acceptance guard
                # (PeerState.set_proposal drops a proposal for another
                # round WITHOUT latching ps.proposal): sending on a
                # round mismatch re-sent the same proposal every
                # iteration with no sleep — a CPU-burning spin against
                # any peer sitting in a different round, found the
                # moment the sim harness made gossip time virtual.
                if rs.height == ps.height and proposal is not None \
                        and ps.round == proposal.round \
                        and not ps.proposal:
                    await peer.send(DATA_CHANNEL, self._stamped(
                        m.ProposalMessage(proposal)))
                    ps.set_proposal(proposal)
                    if parts is not None:
                        ps.set_proposal_parts_header(parts.header())
                    if proposal.pol_round >= 0 and votes is not None:
                        pol = votes.prevotes(proposal.pol_round)
                        if pol is not None:
                            await peer.send(
                                DATA_CHANNEL,
                                m.encode_consensus_msg(m.ProposalPOLMessage(
                                    height=proposal.height,
                                    proposal_pol_round=proposal.pol_round,
                                    proposal_pol=pol.bit_array())))
                    continue
                await asyncio.sleep(self.gossip_sleep)
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("gossip data routine for %r died", ps)

    async def _send_missing_part(self, ps: PeerState, parts, height: int,
                                 round_: int) -> bool:
        if ps.proposal_block_parts is None:
            return False
        missing = parts.parts_bitarray.sub(ps.proposal_block_parts)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        part = parts.get_part(idx)
        if part is None:
            return False
        await ps.peer.send(DATA_CHANNEL, self._stamped(
            m.BlockPartMessage(height=height, round=round_, part=part)))
        ps.set_has_part(height, round_, idx)
        return True

    async def _gossip_catchup_part(self, ps: PeerState) -> bool:
        """Send one part of the block committed at the peer's height —
        only once the peer advertises (via NewValidBlock from its
        enterCommit) that it accepts this part-set; parts pushed before
        then would be dropped on its floor and never re-sent
        (reference: gossipDataForCatchup checks the headers match)."""
        meta = self.cs.block_store.load_block_meta(ps.height)
        if meta is None:
            await asyncio.sleep(self.gossip_sleep)
            return True
        header = meta.block_id.part_set_header
        if ps.proposal_block_parts is None or \
                ps.proposal_block_parts_header != header:
            await asyncio.sleep(self.gossip_sleep)
            return True
        # Burst several parts per iteration: one part per gossip_sleep
        # capped catch-up below the net's commit rate on bigger blocks
        # (same starvation mode as the one-vote-per-tick commit gossip).
        # Every send awaits, so the peer can complete its block and
        # advance (NewRoundStep nulls ps.proposal_block_parts) MID-
        # burst — the common case when bursting works. Re-check the
        # live PeerState each iteration and mark via the guarded
        # set_has_part; a raw .set() here crashed the routine.
        height, round_ = ps.height, ps.round
        missing = ps.proposal_block_parts.not_()
        sent_any = False
        for _ in range(8):
            idx, ok = missing.pick_random()
            if not ok:
                break
            if ps.height != height or ps.proposal_block_parts is None:
                break  # peer advanced mid-burst: done with this height
            part = self.cs.block_store.load_block_part(height, idx)
            if part is None:
                break
            await ps.peer.send(DATA_CHANNEL, self._stamped(
                m.BlockPartMessage(height=height, round=round_,
                                   part=part)))
            ps.set_has_part(height, round_, idx)
            missing.set(idx, False)
            sent_any = True
        if not sent_any:
            await asyncio.sleep(self.gossip_sleep)
        return True

    async def _gossip_votes_routine(self, ps: PeerState) -> None:
        """reference: gossipVotesRoutine (reactor.go:632)."""
        try:
            while True:
                rs = self.cs.rs
                sent = False
                if rs.height == ps.height:
                    sent = await self._gossip_votes_for_height(rs, ps)
                # peer is one height behind: our last commit
                if not sent and ps.height != 0 and \
                        rs.height == ps.height + 1 and \
                        rs.last_commit is not None:
                    sent = await self._pick_send_vote(ps, rs.last_commit)
                # peer is far behind: commit from the block store
                if not sent and ps.height != 0 and \
                        rs.height >= ps.height + 2:
                    sent = await self._gossip_catchup_commit(ps)
                if not sent:
                    await asyncio.sleep(self.gossip_sleep)
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("gossip votes routine for %r died", ps)

    async def _gossip_votes_for_height(self, rs: RoundState,
                                       ps: PeerState) -> bool:
        """reference: gossipVotesForHeight."""
        votes = rs.votes
        if votes is None:
            return False
        # peer is at a previous round: just send its round's votes
        if ps.proposal_pol_round != -1 and ps.step <= RoundStep.PROPOSE:
            pol = votes.prevotes(ps.proposal_pol_round)
            if pol is not None and await self._pick_send_vote(ps, pol):
                return True
        if ps.step <= RoundStep.PREVOTE_WAIT and 0 <= ps.round <= rs.round:
            pv = votes.prevotes(ps.round)
            if pv is not None and await self._pick_send_vote(ps, pv):
                return True
        if ps.step <= RoundStep.PRECOMMIT_WAIT and \
                0 <= ps.round <= rs.round:
            pc = votes.precommits(ps.round)
            if pc is not None and await self._pick_send_vote(ps, pc):
                return True
        if 0 <= ps.round <= rs.round:
            pv = votes.prevotes(ps.round)
            if pv is not None and await self._pick_send_vote(ps, pv):
                return True
        if ps.proposal_pol_round != -1:
            pol = votes.prevotes(ps.proposal_pol_round)
            if pol is not None and await self._pick_send_vote(ps, pol):
                return True
        return False

    def _load_commit(self, height: int):
        """Commit for `height` FOR GOSSIP: the canonical one when block
        height+1 exists, else the locally-seen commit at the tip
        (reference consensus/state.go LoadCommit). Without the tip
        fallback, a peer finishing the tip height can never be fed its
        missing precommits — observed deadlocking a restarted node (and
        with it the whole net, once >1/3 power depended on it).
        Evidence verification deliberately does NOT use this (rounds of
        seen commits differ per node; gossip only needs valid votes)."""
        bs = self.cs.block_store
        if height == bs.height:
            return bs.load_seen_commit(height)
        return bs.load_block_commit(height)

    async def _gossip_catchup_commit(self, ps: PeerState) -> bool:
        commit = self._load_commit(ps.height)
        if commit is None:
            return False
        # Rebuild votes from commit sigs; need that height's valset —
        # reference uses LoadBlockCommit + ps.PickSendVote on a VoteSet
        # view. We send the precommit of a random signer the peer lacks.
        bits = ps.ensure_vote_bits(ps.height, commit.round,
                                   VoteType.PRECOMMIT, len(commit.signatures))
        if bits is None:
            ps.ensure_catchup_commit(ps.height, commit.round,
                                     len(commit.signatures))
            bits = ps.catchup_commit
        if bits is None:
            return False
        have = BitArray(len(commit.signatures))
        for i, cs_ in enumerate(commit.signatures):
            if cs_.for_block():
                have.set(i, True)
        missing = have.sub(bits)
        # Send EVERY missing commit vote in one iteration: a peer this
        # far behind needs the whole commit to advance, and pacing one
        # vote per gossip_sleep put the catch-up rate BELOW the net's
        # commit rate on 6+ validator nets — a restarted node would
        # chase the tip forever (observed in soak runs).
        sent = False
        for idx in range(len(commit.signatures)):
            if not missing.get(idx):
                continue
            vote = self._commit_to_vote(commit, idx)
            if vote is None:
                continue
            await ps.peer.send(VOTE_CHANNEL,
                               self._stamped(m.VoteMessage(vote)))
            bits.set(idx, True)
            sent = True
        return sent

    def _commit_to_vote(self, commit, idx: int):
        from ..types.vote import Vote
        cs_ = commit.signatures[idx]
        if not cs_.for_block():
            return None
        return Vote(type=VoteType.PRECOMMIT, height=commit.height,
                    round=commit.round,
                    block_id=cs_.block_id_for(commit.block_id),
                    timestamp=cs_.timestamp,
                    validator_address=cs_.validator_address,
                    validator_index=idx, signature=cs_.signature)

    async def _pick_send_vote(self, ps: PeerState, vs) -> bool:
        """Pick one vote the peer lacks and send it
        (reference: PeerState.PickSendVote)."""
        peer_bits = ps.ensure_vote_bits(vs.height, vs.round, int(vs.type),
                                        vs.size())
        if peer_bits is None:
            return False
        ours = vs.bit_array()
        missing = ours.sub(peer_bits)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        vote = vs.get_by_index(idx)
        if vote is None:
            return False
        ok = await ps.peer.send(VOTE_CHANNEL,
                                self._stamped(m.VoteMessage(vote)))
        if ok:
            logger.debug("sent vote h=%d r=%d t=%d idx=%d to %s",
                         vote.height, vote.round, int(vote.type), idx,
                         ps.peer.id[:8])
            ps.set_has_vote(vote.height, vote.round, int(vote.type), idx)
        return ok

    async def _query_maj23_routine(self, ps: PeerState) -> None:
        """Periodically tell peers which (h,r,type,blockID) we've seen
        +2/3 votes for, so they can send us what we're missing
        (reference: queryMaj23Routine reactor.go:765)."""
        try:
            while True:
                await asyncio.sleep(PEER_QUERY_MAJ23_SLEEP)
                rs = self.cs.rs
                if rs.votes is None:
                    continue
                if rs.height == ps.height:
                    for type_, vs in ((VoteType.PREVOTE,
                                       rs.votes.prevotes(ps.round)),
                                      (VoteType.PRECOMMIT,
                                       rs.votes.precommits(ps.round))):
                        if vs is None:
                            continue
                        bid, ok = vs.two_thirds_majority()
                        if ok:
                            # NIL majorities announce too (bid None =
                            # +2/3 for nil): the bits-reconciliation
                            # reply is what un-starves a peer whose
                            # votes were sent into its wait_sync window
                            # — skipping nil deadlocked a restarted
                            # node at the prevote step (no proposer ->
                            # the majority IS nil in that scenario).
                            logger.debug(
                                "announce maj23 h=%d r=%d t=%d to %s",
                                rs.height, ps.round, int(type_),
                                ps.peer.id[:8])
                            await ps.peer.send(
                                STATE_CHANNEL,
                                m.encode_consensus_msg(m.VoteSetMaj23Message(
                                    height=rs.height, round=ps.round,
                                    type=int(type_),
                                    block_id=bid or NIL_BLOCK_ID)))
                # catchup: advertise the commit of the peer's height
                if rs.height != ps.height and ps.height > 0 and \
                        ps.height >= self.cs.block_store.base:
                    commit = self._load_commit(ps.height)
                    if commit is not None:
                        await ps.peer.send(
                            STATE_CHANNEL,
                            m.encode_consensus_msg(m.VoteSetMaj23Message(
                                height=ps.height, round=commit.round,
                                type=int(VoteType.PRECOMMIT),
                                block_id=commit.block_id)))
        except asyncio.CancelledError:
            raise
        except UNCAUGHT as e:
            self.halt(e)
        except Exception:
            logger.exception("maj23 routine for %r died", ps)
