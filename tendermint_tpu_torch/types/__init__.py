"""Core consensus types needed by commit verification, the speculation
plane and fast sync (reference capability: types/): blocks, headers,
part sets and commits (types/block.py), votes, evidence and the
validator set. Vote sets come with a later slice of the port."""

from .block import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
from .validator import Validator
from .validator_set import ValidatorSet, VerificationError
from .vote import Vote, VoteType

__all__ = [
    "BlockID", "BlockIDFlag", "Commit", "CommitSig", "PartSetHeader",
    "Validator", "ValidatorSet", "VerificationError", "Vote", "VoteType",
]
