"""Node configuration (reference: config.py) — only the sections this
slice of the port reads."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SpeculationConfig:
    """Verify-ahead pipeline (consensus/speculation.py +
    crypto/cuda/resident.py): commit verification launched
    speculatively as precommits arrive, served at commit time from a
    byte-exact template match — misses fall back to the ordinary
    verify path, so these knobs tune performance, never correctness."""

    # ResidentArena capacity in signature lanes (sentinel included):
    # a 10,240-lane commit plus headroom. 134 B a lane resident, so the
    # default costs 1.6 MB of device memory. Valsets beyond the
    # capacity speculate on the host path.
    arena_lanes: int = 12288
    # speculation entries kept beyond the current height (fast-sync /
    # catch-up lookahead); entries below height-1 retire on commit
    max_heights_ahead: int = 2
    # micro-batch window: patches accumulate this long after the first
    # pending arrival before a speculative launch (0 launches every
    # drain immediately); read by the asyncio flusher, which comes with
    # the consensus-state port (drive flush_sync until then)
    flush_ms: float = 2.0

    def validate_basic(self) -> None:
        if self.arena_lanes < 2:
            raise ValueError(
                "speculation.arena_lanes must be >= 2 (one sentinel "
                "lane + at least one real lane)")
        if self.max_heights_ahead < 1:
            raise ValueError(
                "speculation.max_heights_ahead must be positive")
        if self.flush_ms < 0:
            raise ValueError("negative speculation.flush_ms")
