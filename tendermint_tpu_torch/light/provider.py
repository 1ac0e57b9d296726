"""Light block providers (reference: light/provider.py; Go
light/provider/provider.go).

A provider serves LightBlocks for heights (0 = latest).
BlockStoreProvider serves from a node's local stores. The JSON-RPC
provider comes with the port's RPC layer."""

from __future__ import annotations

from .errors import LightClientError
from .types import LightBlock, SignedHeader


class ProviderError(LightClientError):
    pass


class BlockNotFoundError(ProviderError):
    pass


class Provider:
    async def light_block(self, height: int) -> LightBlock:
        """height 0 → latest. Raises BlockNotFoundError."""
        raise NotImplementedError

    async def report_evidence(self, ev) -> None:
        """Submit LightClientAttackEvidence to the node behind this
        provider (Go reference: light/provider ReportEvidence). Default:
        nowhere to send it."""

    def provider_id(self) -> str:
        return repr(self)


class BlockStoreProvider(Provider):
    """Serves from a full node's block store + state store (the local
    RPC core behaviour light clients hit)."""

    def __init__(self, block_store, state_store, name: str = "local",
                 evidence_pool=None):
        self.block_store = block_store
        self.state_store = state_store
        self.name = name
        self.evidence_pool = evidence_pool

    async def report_evidence(self, ev) -> None:
        if self.evidence_pool is not None:
            self.evidence_pool.add_evidence(ev)

    def provider_id(self) -> str:
        return self.name

    async def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            # head height: only the seen-commit exists so far
            commit = self.block_store.load_seen_commit(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise BlockNotFoundError(f"no light block at height {height}")
        return LightBlock(SignedHeader(meta.header, commit), vals)
