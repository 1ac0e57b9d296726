"""Core consensus types needed by commit verification, the speculation
plane, fast sync, the vote scheduler and the light client (reference
capability: types/): blocks, headers, part sets and commits
(types/block.py), votes, vote sets, evidence, the validator set,
consensus params, block metas and the genesis document."""

from .block import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
from .validator import Validator
from .validator_set import ValidatorSet, VerificationError
from .vote import Vote, VoteType

__all__ = [
    "BlockID", "BlockIDFlag", "Commit", "CommitSig", "PartSetHeader",
    "Validator", "ValidatorSet", "VerificationError", "Vote", "VoteType",
]
