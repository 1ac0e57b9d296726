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


@dataclass
class MeshConfig:
    """Multi-device verify fabric (crypto/cuda/{verify,expanded}.py):
    how the device mesh is used by the verify paths. Performance knobs
    only: verdicts are identical on any mesh."""

    # Key-range sharding crossover for the expanded comb tables: sets of
    # at most this many keys replicate their tables on every device
    # (every table read local, no routing); larger sets split them by
    # key range and route each lane to its key's device, which divides
    # each device's table memory by the mesh size and multiplies the
    # largest set by it. 0 = the default (the single-device budget:
    # replicate while it fits, shard beyond). A set too large for one
    # device shards whatever this says.
    expanded_shard_crossover_keys: int = 0

    def validate_basic(self) -> None:
        if self.expanded_shard_crossover_keys < 0:
            raise ValueError(
                "negative mesh.expanded_shard_crossover_keys")


def apply_mesh(cfg: MeshConfig) -> None:
    """Apply a [mesh] section before anything builds expanded tables
    (the reference applies it while assembling the node)."""
    from .crypto.cuda import expanded

    expanded.set_shard_crossover(cfg.expanded_shard_crossover_keys or None)
