"""Evidence verification (reference: evidence/verify.go) — the
duplicate-vote check.

DuplicateVoteEvidence: both conflicting votes' signatures verify as
one BatchVerifier batch (the reference does two sequential verifies,
verify.go:165-225). Two lanes stay under both device thresholds, so
they verify on the host. ``verify_evidence`` (expiry against state and
the block store) and the light-client-attack check are not ported
yet."""

from __future__ import annotations

from ..crypto.batch import BatchVerifier
from ..types.evidence import DuplicateVoteEvidence, block_key


class EvidenceError(Exception):
    pass


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
