"""Stateful block validation (reference: state/validation.py; Go
state/validation.go:14).

The LastCommit check is a full batched VerifyCommit — on the hot path
this is the single biggest signature workload in block processing, and
it runs as ONE batched verify (at 10,240 validators one structured K3
launch on the GPU) instead of the Go reference's sequential loop."""

from __future__ import annotations

import time

from ..types.block import Block
from ..types.validator_set import VerificationError
from . import State, median_time


class BlockValidationError(Exception):
    pass


def validate_block(state: State, block: Block, evidence_pool=None,
                   speculation=None) -> None:
    block.validate_basic()
    h = block.header

    from . import BLOCK_PROTOCOL_VERSION

    if h.version_block != BLOCK_PROTOCOL_VERSION:
        raise BlockValidationError(
            f"block protocol version {h.version_block} != {BLOCK_PROTOCOL_VERSION}"
        )
    if h.version_app != state.app_version:
        raise BlockValidationError(
            f"app version {h.version_app} != {state.app_version}"
        )
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"chain id {h.chain_id!r} != {state.chain_id!r}"
        )
    if state.last_block_height == 0:
        if h.height != state.initial_height:
            raise BlockValidationError(
                f"expected initial height {state.initial_height}, got {h.height}"
            )
    elif h.height != state.last_block_height + 1:
        raise BlockValidationError(
            f"expected height {state.last_block_height + 1}, got {h.height}"
        )
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong LastBlockID")

    # hashes against current state
    if h.app_hash != state.app_hash:
        raise BlockValidationError("wrong AppHash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong ConsensusHash")
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong NextValidatorsHash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong LastResultsHash")

    # LastCommit: genesis block carries an empty one; later blocks carry
    # +2/3 of the previous validator set — ALL sigs verified, batched.
    if h.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.signatures:
            raise BlockValidationError("initial block can't have LastCommit sigs")
    else:
        if block.last_commit is None:
            raise BlockValidationError("nil LastCommit")
        if len(block.last_commit.signatures) != len(state.last_validators):
            raise BlockValidationError(
                f"LastCommit has {len(block.last_commit.signatures)} sigs, "
                f"need {len(state.last_validators)}"
            )
        from .execution import observe

        t0 = time.perf_counter()
        try:
            # Verify-ahead serve point (consensus/speculation.py): a
            # speculation hit answers from the launch that ran while the
            # precommits were still arriving — zero verification
            # launches here; misses (and commits the plane never saw)
            # take the ordinary batched path.
            served = False
            if speculation is not None:
                served = speculation.serve_commit(
                    state.last_validators, state.chain_id,
                    state.last_block_id, h.height - 1,
                    block.last_commit)
            if not served:
                state.last_validators.verify_commit(
                    state.chain_id, state.last_block_id,
                    h.height - 1, block.last_commit,
                )
        except VerificationError as e:
            raise BlockValidationError(f"invalid LastCommit: {e}") from e
        finally:
            observe("commit_verify_seconds", time.perf_counter() - t0)

    # time: initial block matches genesis; later blocks carry the
    # weighted median of LastCommit timestamps (BFT time) and must be
    # strictly after the previous block
    if h.height == state.initial_height:
        if h.time != state.last_block_time:
            raise BlockValidationError("genesis block time mismatch")
    else:
        if h.time <= state.last_block_time:
            raise BlockValidationError("block time not after last block")
        expected = median_time(block.last_commit, state.last_validators)
        if h.time != expected:
            raise BlockValidationError(
                f"block time {h.time} != median commit time {expected}"
            )

    # evidence size + validity
    max_ev = state.consensus_params.evidence.max_bytes
    ev_bytes = sum(len(e.to_bytes()) for e in block.evidence.evidence)
    if ev_bytes > max_ev:
        raise BlockValidationError("evidence exceeds max bytes")
    if evidence_pool is not None and block.evidence.evidence:
        evidence_pool.check_evidence(block.evidence.evidence)

    if not state.validators.has_address(h.proposer_address):
        raise BlockValidationError("proposer not in validator set")
