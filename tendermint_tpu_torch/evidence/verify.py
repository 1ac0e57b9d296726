"""Evidence verification (reference: evidence/verify.py; Go
evidence/verify.go): expiry against the committed state and the block
store, then the check of each kind.

DuplicateVoteEvidence: both conflicting votes' signatures verify as
one BatchVerifier batch (Go does two sequential verifies,
verify.go:165-225). Two lanes stay under both device thresholds, so
they verify on the host. LightClientAttackEvidence: the conflicting
commit verifies against the node's own chain — the common height's
set with 1/3 trust (one K4 launch at 150 validators: 51 lanes) or the
set at the conflicting height with +2/3 (101 lanes) — and the
byzantine set, powers and timestamp are re-derived."""

from __future__ import annotations

from ..crypto.batch import BatchVerifier
from ..types.evidence import DuplicateVoteEvidence, Evidence, block_key


class EvidenceError(Exception):
    pass


def verify_evidence(ev: Evidence, state, state_store, block_store) -> None:
    """Full verification against committed chain state (Go reference:
    evidence/verify.go:25 Verify + prepare checks)."""
    height = ev.height()
    header_time = _committed_block_time(block_store, height)

    # expiry relative to consensus params (Go verify.go:33-47: expired
    # only when BOTH height- and time-age are exceeded)
    p = state.consensus_params.evidence
    age_blocks = state.last_block_height - height
    age_ns = state.last_block_time - header_time
    if age_blocks > p.max_age_num_blocks and age_ns > p.max_age_duration_ns:
        raise EvidenceError(
            f"evidence from height {height} is too old "
            f"({age_blocks} blocks / {age_ns / 1e9:.0f}s)")

    if isinstance(ev, DuplicateVoteEvidence):
        vals = state_store.load_validators(height)
        if vals is None:
            raise EvidenceError(f"no validator set at height {height}")
        verify_duplicate_vote(ev, state.chain_id, vals, header_time)
        return
    from ..light.types import LightClientAttackEvidence

    if isinstance(ev, LightClientAttackEvidence):
        common_vals = state_store.load_validators(height)
        if common_vals is None:
            raise EvidenceError(f"no validator set at height {height}")
        verify_light_client_attack(
            ev, state.chain_id, common_vals, header_time, state_store,
            block_store)
        return
    raise EvidenceError(f"unknown evidence type {type(ev).__name__}")


def _committed_block_time(block_store, height: int) -> int:
    meta = block_store.load_block_meta(height)
    if meta is None:
        raise EvidenceError(f"no committed block at evidence height {height}")
    return meta.header.time


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str,
                          vals, header_time: int) -> None:
    """reference: evidence/verify.go:165 VerifyDuplicateVote."""
    a, b = ev.vote_a, ev.vote_b

    if a.height != b.height or a.round != b.round or a.type != b.type:
        raise EvidenceError("votes are from different H/R/S")
    if a.validator_address != b.validator_address:
        raise EvidenceError("votes are from different validators")
    if a.block_id == b.block_id:
        raise EvidenceError("votes are for the same block id")
    if not block_key(a.block_id) < block_key(b.block_id):
        raise EvidenceError("votes not in canonical order")

    _, val = vals.get_by_address(a.validator_address)
    if val is None:
        raise EvidenceError(
            f"validator {a.validator_address.hex()} not in set at "
            f"height {a.height}")

    # recorded powers must match the valset (they feed ABCI punishment)
    if ev.validator_power != val.voting_power:
        raise EvidenceError(
            f"validator power mismatch: {ev.validator_power} != "
            f"{val.voting_power}")
    if ev.total_voting_power != vals.total_voting_power():
        raise EvidenceError("total voting power mismatch")
    if ev.timestamp != header_time:
        raise EvidenceError(
            f"evidence time {ev.timestamp} != block time {header_time}")

    bv = BatchVerifier()
    bv.add(val.pub_key, a.sign_bytes(chain_id), a.signature)
    bv.add(val.pub_key, b.sign_bytes(chain_id), b.signature)
    ok, verdicts = bv.verify()
    if not ok:
        which = "A" if not verdicts[0] else "B"
        raise EvidenceError(f"invalid signature on vote {which}")


def verify_light_client_attack(ev, chain_id: str, common_vals,
                               common_time: int, state_store,
                               block_store) -> None:
    """Go reference: evidence/verify.go:123 VerifyLightClientAttack.

    The commit of the conflicting block must verify against OUR chain:
    through the common-height valset with 1/3 trust when the fork is
    non-adjacent (a lunatic attack forges later valsets, so only the
    common ancestor's set is meaningful), or through the valset at that
    exact height for a same-height equivocation. The recorded byzantine
    set, powers and timestamp are re-derived and must match — they feed
    ABCI punishment and must not be attacker-chosen.
    """
    from ..light.types import (
        SignedHeader, compute_byzantine_validators,
        conflicting_header_is_invalid,
    )
    from ..types.validator_set import VerificationError

    cb = ev.conflicting_block
    sh = cb.signed_header
    c_height = sh.header.height

    # Our signed header at the conflicting height. ONLY the canonical
    # commit (stored with block c_height+1) may be used: a locally-seen
    # commit can be at a DIFFERENT round, which would make the
    # equivocation-vs-amnesia classification — and thus accept/reject —
    # node-dependent. Tip evidence fails here and is retried by gossip
    # once the next block lands (Go getSignedHeader does the same).
    trusted_meta = block_store.load_block_meta(c_height)
    trusted_commit = block_store.load_block_commit(c_height)
    if trusted_meta is None or trusted_commit is None:
        raise EvidenceError(
            f"no committed header+commit at conflicting height "
            f"{c_height} (commit lands with block {c_height + 1})")
    if trusted_meta.header.hash() == sh.header.hash():
        raise EvidenceError("conflicting block matches the committed chain")
    trusted_sh = SignedHeader(trusted_meta.header, trusted_commit)

    # The conflicting block must be self-consistent (its commit signs
    # its header; its valset matches the header's validators_hash).
    try:
        cb.validate_basic(chain_id)
    except ValueError as e:
        raise EvidenceError(f"invalid conflicting block: {e}") from e

    try:
        if ev.common_height != c_height:
            # Non-adjacent fork: >= 1/3 of the common valset must have
            # signed the conflicting block (Go verify.go:138).
            common_vals.verify_commit_light_trusting(
                chain_id, sh.commit, 1, 3)
        else:
            # Same-height evidence must be a correctly-derived header
            # (equivocation/amnesia); a lunatic header at the SAME
            # height is nonsense (Go verify.go:135-139).
            if conflicting_header_is_invalid(sh.header,
                                             trusted_meta.header):
                raise EvidenceError(
                    "common height equals conflicting height, so the "
                    "conflicting block must be correctly derived, but "
                    "its deterministic header fields differ")
            vals_at = state_store.load_validators(c_height)
            if vals_at is None:
                raise EvidenceError(
                    f"no validator set at height {c_height}")
            if sh.header.validators_hash != vals_at.hash():
                raise EvidenceError(
                    "equivocation evidence with foreign validator set")
            vals_at.verify_commit_light(
                chain_id, sh.commit.block_id, c_height, sh.commit)
    except VerificationError as e:
        raise EvidenceError(
            f"conflicting commit failed verification: {e}") from e

    expected = compute_byzantine_validators(common_vals, trusted_sh, cb)
    got = ev.byzantine_validators
    # A mismatch is attacker-chosen punishment data; an empty set that
    # MATCHES the derivation is legitimate amnesia evidence (Go
    # verify.go accepts a nil byzantine set for amnesia attacks).
    if [(v.address, v.voting_power) for v in got] != \
            [(v.address, v.voting_power) for v in expected]:
        raise EvidenceError("byzantine validator set mismatch")
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceError("total voting power mismatch")
    if ev.timestamp != common_time:
        raise EvidenceError(
            f"evidence time {ev.timestamp} != common block time "
            f"{common_time}")
