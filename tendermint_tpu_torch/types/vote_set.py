"""VoteSet: vote accumulation toward +2/3 (reference: types/vote_set.go;
port of tendermint_tpu/types/vote_set.py).

Semantics preserved from the reference: one vote slot per validator
index; duplicate identical votes are no-ops; conflicting votes (same
validator, different block) raise ConflictingVoteError carrying both
votes (the raw material for DuplicateVoteEvidence) — and are tracked if
a peer has claimed a +2/3 majority for that block.

The signature check supports two modes: the synchronous host path
(verify=True, matching vote_set.go:203) and a pre-verified path used by
the consensus micro-batching scheduler (consensus/state.py
VoteScheduler), which verifies many votes in one device batch FIRST and
then commits them here with verify=False. Every non-signature check
(duplicate, conflict, index, address) re-runs at commit time in both
modes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs.bits import BitArray
from .block import BlockID
from .vote import MAX_VOTES_COUNT, Vote, VoteType


class VoteSetError(Exception):
    pass


@dataclass
class ConflictingVoteError(Exception):
    existing: Vote
    new: Vote

    def __str__(self) -> str:
        return (
            f"conflicting votes from validator "
            f"{self.new.validator_address.hex()}"
        )


@dataclass
class _BlockVotes:
    peer_maj23: bool
    bit_array: BitArray
    votes: list[Vote | None]
    sum: int

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(peer_maj23, BitArray(num_validators), [None] * num_validators, 0)

    def add_verified_vote(self, vote: Vote, power: int) -> None:
        i = vote.validator_index
        if self.votes[i] is None:
            self.bit_array.set(i, True)
            self.votes[i] = vote
            self.sum += power


def _block_key(block_id: BlockID | None) -> bytes:
    return b"" if block_id is None else block_id.key()


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 type_: VoteType, val_set):
        if height == 0:
            raise ValueError("height must be positive")
        if len(val_set) > MAX_VOTES_COUNT:
            raise ValueError(
                f"validator set exceeds MAX_VOTES_COUNT ({MAX_VOTES_COUNT})"
            )
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = type_
        self.val_set = val_set
        self.votes_bit_array = BitArray(len(val_set))
        self.votes: list[Vote | None] = [None] * len(val_set)
        self.sum = 0
        self.maj23: BlockID | None = None
        self.maj23_set = False  # distinguishes 'majority for nil' from 'none'
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    def size(self) -> int:
        return len(self.val_set)

    def is_duplicate(self, vote: Vote) -> bool:
        """True if an identical vote (index, block, signature) is
        already tallied — used by the consensus micro-batch scheduler to
        skip re-verifying gossip duplicates before they reach a device
        lane (the in-set dup check in add_vote still runs at commit)."""
        i = vote.validator_index
        if not 0 <= i < len(self.votes):
            return False
        ex = self.votes[i]
        if ex is None:
            bv = self.votes_by_block.get(_block_key(vote.block_id))
            ex = bv.votes[i] if bv is not None else None
        return (
            ex is not None
            and _block_key(ex.block_id) == _block_key(vote.block_id)
            and ex.signature == vote.signature
        )

    def add_vote(self, vote: Vote | None, verify: bool = True) -> bool:
        """Returns True if the vote was added, False if it was a
        duplicate. Raises VoteSetError on invalid votes and
        ConflictingVoteError on equivocation."""
        if vote is None:
            raise VoteSetError("nil vote")
        val_index = vote.validator_index
        if val_index < 0:
            raise VoteSetError("negative validator index")
        if not vote.signature:
            raise VoteSetError("vote missing signature")
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.type}, got "
                f"{vote.height}/{vote.round}/{vote.type}"
            )
        if vote.block_id is not None:
            try:
                vote.block_id.validate_basic()
            except ValueError as e:
                raise VoteSetError(f"bad block_id in vote: {e}") from None
        val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteSetError(f"no validator at index {val_index}")
        if vote.validator_address != val.address:
            raise VoteSetError("vote validator address mismatch")

        # Duplicate check before the expensive verify.
        existing = self.votes[val_index]
        if existing is not None:
            if _block_key(existing.block_id) == _block_key(vote.block_id):
                if existing.signature == vote.signature:
                    return False
                raise VoteSetError("same block, different signature")

        if verify and not vote.verify(self.chain_id, val.pub_key):
            raise VoteSetError(f"invalid signature from {val.address.hex()}")

        return self._add_verified(vote, val.voting_power)

    def _add_verified(self, vote: Vote, power: int) -> bool:
        val_index = vote.validator_index
        block_key = _block_key(vote.block_id)
        existing = self.votes[val_index]
        conflicting: Vote | None = None

        bv = self.votes_by_block.get(block_key)
        if existing is not None and _block_key(existing.block_id) != block_key:
            conflicting = existing
            # Only accept the new vote into a block's tally if a peer
            # claims +2/3 for that block (reference vote_set.go:231).
            if bv is None or not bv.peer_maj23:
                raise ConflictingVoteError(existing, vote)
        elif existing is None:
            self.votes[val_index] = vote
            self.votes_bit_array.set(val_index, True)
            self.sum += power

        if bv is None:
            bv = _BlockVotes.new(False, self.size())
            self.votes_by_block[block_key] = bv

        old_sum = bv.sum
        quorum = 2 * self.val_set.total_voting_power() // 3 + 1
        bv.add_verified_vote(vote, power)

        if old_sum < quorum <= bv.sum and not self.maj23_set:
            self.maj23_set = True
            self.maj23 = vote.block_id
            # Promote this block's votes into the main tracking.
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v

        if conflicting is not None:
            raise ConflictingVoteError(conflicting, vote)
        return True

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id (reference vote_set.go:290)."""
        try:
            block_id.validate_basic()  # untrusted input: bound the hash
        except ValueError as e:
            raise VoteSetError(f"invalid peer maj23 block id: {e}") from e
        block_key = _block_key(block_id)
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing.key() == block_key:
                return
            raise VoteSetError("peer changed its +2/3 claim")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes.new(True, self.size())

    # -- queries --

    def get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        v = self.votes[val_index] if 0 <= val_index < len(self.votes) else None
        if v is not None and _block_key(v.block_id) == block_key:
            return v
        bv = self.votes_by_block.get(block_key)
        if bv is not None and 0 <= val_index < len(bv.votes):
            return bv.votes[val_index]
        return None

    def get_by_index(self, i: int) -> Vote | None:
        return self.votes[i] if 0 <= i < len(self.votes) else None

    def two_thirds_majority(self) -> tuple[BlockID | None, bool]:
        """(block_id, ok): ok=True with block_id=None means +2/3 for nil."""
        return self.maj23, self.maj23_set

    def has_two_thirds_majority(self) -> bool:
        return self.maj23_set

    def has_two_thirds_any(self) -> bool:
        return 3 * self.sum > 2 * self.val_set.total_voting_power()

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID | None) -> BitArray | None:
        bv = self.votes_by_block.get(_block_key(block_id))
        return bv.bit_array.copy() if bv else None

    def make_commit(self):
        """Build a Commit from the +2/3 majority (reference
        vote_set.go:633). Requires a non-nil maj23."""
        from .block import BlockIDFlag, Commit, CommitSig

        if self.type != VoteType.PRECOMMIT:
            raise VoteSetError("cannot make commit from non-precommit set")
        if not self.maj23_set or self.maj23 is None or self.maj23.is_nil():
            raise VoteSetError("no +2/3 block majority")
        sigs = []
        for i, v in enumerate(self.votes):
            if v is None or v.is_nil():
                if v is None:
                    sigs.append(CommitSig.absent())
                else:
                    sigs.append(CommitSig(
                        BlockIDFlag.NIL, v.validator_address, v.timestamp,
                        v.signature,
                    ))
                continue
            if _block_key(v.block_id) != self.maj23.key():
                sigs.append(CommitSig.absent())
                continue
            sigs.append(CommitSig(
                BlockIDFlag.COMMIT, v.validator_address, v.timestamp,
                v.signature,
            ))
        return Commit(self.height, self.round, self.maj23, sigs)
