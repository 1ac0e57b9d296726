"""Pluggable per-height consensus misbehavior — the "maverick" node
(reference: consensus/misbehavior.py; Go test/maverick/consensus/
misbehavior.go, test/maverick/README).

A Misbehavior overrides individual state-machine steps for heights it
is scheduled at (`ConsensusState.misbehaviors: {height: Misbehavior}`).
Hook methods return True when they fully handled the step (the default
logic is skipped), False to fall through — so one misbehavior can
override a single step and inherit the rest.

Unlike the Go reference (which forks the whole consensus package to
embed hooks), the hooks live in the ONE state machine behind two `if` lines
— the production step logic stays the only implementation, and a
maverick node is just a node with a non-empty schedule. Signing of the
conflicting artifact bypasses the PrivValidator's double-sign
protection by signing with the raw key — exactly what real byzantine
hardware would do; the protection exists to stop honest mistakes, not
attackers.
"""

from __future__ import annotations

from ..libs import clock as _clock

from ..types.block import BlockID
from ..types.proposal import Proposal
from ..types.vote import Vote, VoteType
from . import messages as m

MISBEHAVIORS: dict[str, type] = {}


def register(cls):
    MISBEHAVIORS[cls.name] = cls
    return cls


class Misbehavior:
    """Default: every hook falls through to the honest implementation."""

    name = "default"

    async def enter_propose(self, cs, height: int, round_: int) -> bool:
        return False

    async def enter_prevote(self, cs, height: int, round_: int) -> bool:
        return False

    async def enter_precommit(self, cs, height: int, round_: int) -> bool:
        return False


def _raw_sign_vote(cs, vote: Vote) -> Vote:
    """Sign a vote with the validator's raw key, bypassing the
    PrivValidator's last-sign-state double-sign protection (a byzantine
    signer is not constrained by its own safety belt)."""
    priv = cs.priv_validator.priv_key  # MockPV/FilePV both expose it
    vote.signature = priv.sign(vote.sign_bytes(cs.state.chain_id))
    return vote


def _make_vote(cs, type_: VoteType, hash_: bytes, psh) -> Vote:
    idx, _ = cs.rs.validators.get_by_address(cs.priv_validator_address)
    return Vote(
        type=type_,
        height=cs.rs.height,
        round=cs.rs.round,
        block_id=BlockID(hash_, psh) if hash_ else None,
        timestamp=_clock.time_ns(),
        validator_address=cs.priv_validator_address,
        validator_index=idx,
    )


@register
class DoublePrevote(Misbehavior):
    """Prevote BOTH the proposal block and nil in the same round
    (Go DoublePrevoteMisbehavior): half the peers see each, and
    honest nodes that gossip them to each other assemble
    DuplicateVoteEvidence from the conflict."""

    name = "double-prevote"

    async def enter_prevote(self, cs, height: int, round_: int) -> bool:
        rs = cs.rs
        if cs.priv_validator is None or rs.validators is None or \
                not rs.validators.has_address(cs.priv_validator_address):
            return False
        if rs.locked_block is not None or rs.proposal_block is None:
            return False  # behave honestly without a target block
        block_vote = _raw_sign_vote(cs, _make_vote(
            cs, VoteType.PREVOTE, rs.proposal_block.hash(),
            rs.proposal_block_parts.header()))
        nil_vote = _raw_sign_vote(cs, _make_vote(
            cs, VoteType.PREVOTE, b"", None))
        # Count the block vote ourselves; split the conflict across
        # peers (even -> block, odd -> nil).
        cs._send_internal(m.VoteMessage(block_vote))
        cs._broadcast("vote_split", (m.VoteMessage(block_vote),
                                     m.VoteMessage(nil_vote)))
        cs.logger.warning("MAVERICK double-prevote at %d/%d",
                          height, round_)
        return True


@register
class DoublePropose(Misbehavior):
    """As proposer, sign TWO different proposals for the same
    height/round and send one to each half of the peers."""

    name = "double-propose"

    async def enter_propose(self, cs, height: int, round_: int) -> bool:
        # Round 0 only, one-shot: a split proposal usually fails its
        # round (half the peers hold each block, no polka), and if
        # EVERY round's rotating proposer re-equivocated the height
        # would livelock. One equivocation is the attack; all later
        # rounds/proposers proceed honestly and consensus recovers.
        if round_ != 0:
            cs.misbehaviors.pop(height, None)
            return False
        if not cs._is_proposer() or cs.priv_validator is None:
            return False
        cs.misbehaviors.pop(height, None)
        rs = cs.rs
        from ..types.block import Commit, NIL_BLOCK_ID

        if height == cs.state.initial_height:
            commit = Commit(0, 0, NIL_BLOCK_ID, [])
        elif rs.last_commit is not None and \
                rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
        else:
            return False
        priv = cs.priv_validator.priv_key
        proposals = []
        for variant in (b"", b"\xfe maverick fork \xfe"):
            block = cs.block_exec.create_proposal_block(
                height, cs.state, commit, cs.priv_validator_address)
            if variant:
                block.data.txs = list(block.data.txs) + [variant]
                block.header.data_hash = block.data.hash()
            parts = block.make_part_set()
            prop = Proposal(
                height=height, round=round_, pol_round=rs.valid_round,
                block_id=BlockID(block.hash(), parts.header()),
                timestamp=_clock.time_ns(),
            )
            prop.signature = priv.sign(
                prop.sign_bytes(cs.state.chain_id))
            proposals.append((prop, parts))
        # Feed ourselves the first; split the two across peers.
        prop_a, parts_a = proposals[0]
        cs._send_internal(m.ProposalMessage(prop_a))
        for i in range(parts_a.total):
            cs._send_internal(m.BlockPartMessage(
                height, round_, parts_a.get_part(i)))
        cs._broadcast("proposal_split", (proposals[0], proposals[1]))
        cs.logger.warning("MAVERICK double-propose at %d/%d",
                          height, round_)
        return True
