"""Core consensus types needed by commit verification and the
speculation plane (reference capability: types/). Header, Block,
PartSet and vote sets come with later slices of the port."""

from .block import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
from .validator import Validator
from .validator_set import ValidatorSet, VerificationError
from .vote import Vote, VoteType

__all__ = [
    "BlockID", "BlockIDFlag", "Commit", "CommitSig", "PartSetHeader",
    "Validator", "ValidatorSet", "VerificationError", "Vote", "VoteType",
]
