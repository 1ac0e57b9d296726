"""Light block providers (reference: light/provider.py; Go
light/provider/provider.go).

A provider serves LightBlocks for heights (0 = latest). RPCProvider
fetches them from a node's JSON-RPC `commit` and `validators` routes
(the state-sync light client's providers); BlockStoreProvider serves
from a node's local stores."""

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


class RPCProvider(Provider):
    """Fetches light blocks from a node's JSON-RPC `commit` +
    `validators` routes (Go reference: light/provider/http)."""

    def __init__(self, host: str, port: int, name: str = ""):
        from ..rpc.jsonrpc import HTTPClient

        self.client = HTTPClient(host, port)
        self.name = name or f"{host}:{port}"

    def provider_id(self) -> str:
        return self.name

    async def light_block(self, height: int) -> LightBlock:
        from ..rpc.core import (
            commit_from_json, header_from_json, validator_set_from_json,
        )
        from ..rpc.jsonrpc import RPCError

        try:
            params = {} if height == 0 else {"height": height}
            cm = await self.client.call("commit", **params)
            header = header_from_json(cm["signed_header"]["header"])
            commit = commit_from_json(cm["signed_header"]["commit"])
            vals_pages = []
            page = 1
            # Bound pagination against a malicious provider: an
            # inflated `total` with empty pages must not spin forever
            # (reference http provider caps pages); a truncated set is
            # caught downstream by the valset-hash check.
            max_pages = 1 + (10_000 // 100)  # MaxVotesCount / per_page
            while page <= max_pages:
                v = await self.client.call("validators",
                                           height=header.height,
                                           page=page, per_page=100)
                if not v["validators"]:
                    break  # provider returned an empty page: stop
                vals_pages.extend(v["validators"])
                if len(vals_pages) >= int(v["total"]):
                    break
                page += 1
            vals = validator_set_from_json(vals_pages)
        except RPCError as e:
            # Only height-not-there responses are "not found" (the
            # normal not-committed-yet signal, which must NOT trigger
            # primary failover); any other JSON-RPC error — internal
            # errors, broken handlers — is a provider failure.
            msg = str(e)
            if "not available" in msg or "not found" in msg:
                raise BlockNotFoundError(msg) from e
            raise ProviderError(msg) from e
        except (ValueError, KeyError, TypeError) as e:
            # malformed/truncated responses (HTML 502 pages, bad JSON,
            # missing fields) are transport-class provider failures
            raise ProviderError(f"malformed response: {e}") from e
        return LightBlock(SignedHeader(header, commit), vals)

    async def report_evidence(self, ev) -> None:
        import base64

        from ..rpc.jsonrpc import RPCError

        try:
            await self.client.call(
                "broadcast_evidence",
                evidence=base64.b64encode(ev.to_bytes()).decode())
        except RPCError as e:
            raise ProviderError(str(e)) from e


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
