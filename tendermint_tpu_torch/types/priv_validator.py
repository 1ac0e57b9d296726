"""PrivValidator interface (reference: types/priv_validator.py; Go
types/priv_validator.go).

The signing abstraction consensus uses: FilePV (privval/) persists
last-sign state for double-sign protection; MockPV is the in-memory
test implementation.
"""

from __future__ import annotations

from .. import crypto
from ..crypto import ed25519


class PrivValidator:
    def get_pub_key(self) -> crypto.PubKey:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote) -> None:
        """Sets vote.signature in place (raises on refusal)."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal) -> None:
        raise NotImplementedError


class MockPV(PrivValidator):
    """In-memory signer for tests; no double-sign protection."""

    def __init__(self, priv_key: crypto.PrivKey | None = None,
                 break_proposal_sigs: bool = False,
                 break_vote_sigs: bool = False):
        self.priv_key = priv_key or ed25519.Ed25519PrivKey.generate()
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    def get_pub_key(self) -> crypto.PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote) -> None:
        if self.break_vote_sigs:
            chain_id = "incorrect-chain-id"
        vote.signature = self.priv_key.sign(vote.sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal) -> None:
        if self.break_proposal_sigs:
            chain_id = "incorrect-chain-id"
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(chain_id))
