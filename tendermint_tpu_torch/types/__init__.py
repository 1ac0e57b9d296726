"""Core consensus types needed by commit verification (reference
capability: types/). Header, Block, PartSet, votes and vote sets come
with later slices of the port."""

from .block import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
from .validator import Validator
from .validator_set import ValidatorSet, VerificationError

__all__ = [
    "BlockID", "BlockIDFlag", "Commit", "CommitSig", "PartSetHeader",
    "Validator", "ValidatorSet", "VerificationError",
]
