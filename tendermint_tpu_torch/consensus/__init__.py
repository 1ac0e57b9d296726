"""Consensus-side planes of the port (reference capability:
consensus/). This slice carries the verify-ahead SpeculationPlane;
the consensus state machine, reactor and WAL come with later slices."""

from .speculation import SpeculationPlane

__all__ = ["SpeculationPlane"]
