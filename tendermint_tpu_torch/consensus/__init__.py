"""Consensus engine of the port (reference: consensus/).

The Tendermint BFT state machine (state.py ConsensusState), asyncio
native: one serialized receive loop per instance fed by a two-class
bounded funnel, a WAL written before acting on any message (wal.py),
a timeout ticker (ticker.py), and gossip hooks a reactor attaches to.
Votes verify in batches through the vote micro-batch scheduler
(VoteScheduler, batch_verdicts) and tally into the round types
(cstypes.py RoundState, HeightVoteSet); commits are served ahead of
time by the verify-ahead SpeculationPlane and its flusher; the wire
codec is messages.py; the maverick hooks are misbehavior.py; the
startup handshake and reconciliation are replay.py. The reactor comes
with the p2p port."""

from .cstypes import HeightVoteSet, RoundState, RoundStep
from .misbehavior import MISBEHAVIORS, DoublePrevote, DoublePropose, Misbehavior
from .speculation import SpeculationPlane, active_plane
from .state import ConsensusState, VoteScheduler, batch_verdicts
from .ticker import TimeoutTicker

__all__ = ["ConsensusState", "DoublePrevote", "DoublePropose",
           "HeightVoteSet", "MISBEHAVIORS", "Misbehavior", "RoundState",
           "RoundStep", "SpeculationPlane", "TimeoutTicker",
           "VoteScheduler", "active_plane", "batch_verdicts"]
