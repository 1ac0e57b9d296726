"""Consensus round types (reference: consensus/cstypes.py; Go
consensus/types/): RoundStep progression, RoundState (the full mutable
state of one consensus instance, round_state.go:67) and HeightVoteSet
(per-round prevote/precommit VoteSets, height_vote_set.go:41)."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..types.block import Block, BlockID, PartSet
from ..types.proposal import Proposal
from ..types.validator_set import ValidatorSet
from ..types.vote import Vote, VoteType
from ..types.vote_set import VoteSet, VoteSetError


class RoundStep(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class RoundState:
    """Reference: consensus/types/round_state.go:67."""

    height: int = 0
    round: int = 0
    step: RoundStep = RoundStep.NEW_HEIGHT
    start_time: float = 0.0
    commit_time: float = 0.0
    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None
    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None
    votes: "HeightVoteSet | None" = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def proposal_complete(self) -> bool:
        return (
            self.proposal is not None
            and self.proposal_block is not None
        )


class HeightVoteSet:
    """Prevotes+precommits for every round of one height, created
    lazily up to round+1 (reference: height_vote_set.go).

    Tracks one catchup round per peer: a peer claiming +2/3 at a
    future round lets us open vote sets there (SetPeerMaj23)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._round_vote_sets: dict[int, tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)
        self._add_round(1)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        self._round_vote_sets[round_] = (
            VoteSet(self.chain_id, self.height, round_, VoteType.PREVOTE,
                    self.val_set),
            VoteSet(self.chain_id, self.height, round_, VoteType.PRECOMMIT,
                    self.val_set),
        )

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist through round+1."""
        if round_ < self.round:
            raise ValueError("set_round going backwards")
        for r in range(self.round, round_ + 2):
            self._add_round(r)
        self.round = round_

    def prevotes(self, round_: int) -> VoteSet | None:
        rs = self._round_vote_sets.get(round_)
        return rs[0] if rs else None

    def precommits(self, round_: int) -> VoteSet | None:
        rs = self._round_vote_sets.get(round_)
        return rs[1] if rs else None

    def add_vote(self, vote: Vote, peer_id: str = "",
                 verify: bool = True) -> bool:
        """Route to the right round's VoteSet. Votes from rounds beyond
        round+1 are only admitted once per peer (catchup; DoS bound,
        reference height_vote_set.go AddVote). verify=False commits a
        vote whose signature the micro-batch scheduler already checked
        on the device."""
        if not VoteType.is_valid(int(vote.type)):
            raise VoteSetError("invalid vote type")
        vs = self._get(vote.round, vote.type)
        if vs is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vs = self._get(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise VoteSetError(
                    f"unwanted round {vote.round} from peer {peer_id}"
                )
        return vs.add_vote(vote, verify=verify)

    def _get(self, round_: int, type_: VoteType) -> VoteSet | None:
        return (self.prevotes(round_) if type_ == VoteType.PREVOTE
                else self.precommits(round_))

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a prevote +2/3 (proof-of-lock)."""
        for r in sorted(self._round_vote_sets, reverse=True):
            pv = self.prevotes(r)
            if pv is not None:
                bid, ok = pv.two_thirds_majority()
                if ok:
                    return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, type_: VoteType, peer_id: str,
                       block_id: BlockID) -> None:
        self._add_round(round_)
        vs = self._get(round_, type_)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)
