"""Trusted-state provider for statesync (reference:
statesync/stateprovider.py; Go statesync/stateprovider.go:28).

Builds the sm.State a node resumes from after restoring a snapshot at
height h — every field comes from LIGHT-CLIENT-VERIFIED headers, so a
lying snapshot peer can at worst waste bandwidth, never forge state:

  h   → last block (the snapshotted height)
  h+1 → current block: its app_hash is what the restored app must match
  h+2 → next block: carries the valset that takes effect after h+1

The light client is the port's `light.Client`: at a large set each
commit check is one structured K3 launch over the set's comb tables
(K1 builds them once), K2's assembly inside it.
"""

from __future__ import annotations

from ..state import State
from ..types.params import ConsensusParams


class StateProvider:
    async def app_hash(self, height: int) -> bytes:
        raise NotImplementedError

    async def commit(self, height: int):
        raise NotImplementedError

    async def state(self, height: int) -> State:
        raise NotImplementedError


class LightClientStateProvider(StateProvider):
    def __init__(self, light_client, initial_height: int = 1,
                 consensus_params: ConsensusParams | None = None):
        self.lc = light_client
        self.initial_height = initial_height or 1
        # params can't be light-verified in the reference either (they
        # aren't in the header); taken from config/genesis
        self.consensus_params = consensus_params or ConsensusParams()

    async def app_hash(self, height: int) -> bytes:
        """App hash the restored snapshot must reproduce — lives in the
        NEXT header (reference stateprovider.go:90 AppHash; it also
        probes h+2 so State() can't fail later)."""
        # verify h FIRST: the client only walks forward, so later
        # State()/Commit() calls for h must find it already trusted
        await self.lc.verify_light_block_at_height(height)
        nxt = await self.lc.verify_light_block_at_height(height + 1)
        await self.lc.verify_light_block_at_height(height + 2)
        return nxt.signed_header.header.app_hash

    async def commit(self, height: int):
        lb = await self.lc.verify_light_block_at_height(height)
        return lb.signed_header.commit

    async def state(self, height: int) -> State:
        last = await self.lc.verify_light_block_at_height(height)
        cur = await self.lc.verify_light_block_at_height(height + 1)
        nxt = await self.lc.verify_light_block_at_height(height + 2)
        return State(
            chain_id=self.lc.chain_id,
            initial_height=self.initial_height,
            last_block_height=last.height(),
            last_block_id=last.signed_header.commit.block_id,
            last_block_time=last.time(),
            validators=cur.validator_set.copy(),
            next_validators=nxt.validator_set.copy(),
            last_validators=last.validator_set.copy(),
            last_height_validators_changed=nxt.height(),
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=self.initial_height,
            last_results_hash=cur.signed_header.header.last_results_hash,
            app_hash=cur.signed_header.header.app_hash,
        )
