"""Consensus-side planes of the port (reference capability:
consensus/): the verify-ahead SpeculationPlane, the vote micro-batch
scheduler and the round types it tallies into, the WAL (wal.py) and the
startup handshake and reconciliation (replay.py). The consensus state
machine and reactor come with later slices."""

from .cstypes import HeightVoteSet, RoundStep
from .speculation import SpeculationPlane
from .state import VoteScheduler, batch_verdicts

__all__ = ["HeightVoteSet", "RoundStep", "SpeculationPlane",
           "VoteScheduler", "batch_verdicts"]
