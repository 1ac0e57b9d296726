"""Consensus state — the deterministic summary of the chain used to
validate and execute the next block (reference: state/__init__.py; Go
state/state.go).

State is treated as immutable: every mutation returns a fresh copy
(matching the Go reference's value-semantics State struct). The block
executor is execution.py, block validation validation.py."""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass

from ..crypto import merkle
from ..encoding.proto import Writer
from ..types.block import Block, BlockID, Commit, Data, Header, NIL_BLOCK_ID
from ..types.evidence import EvidenceData
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet

BLOCK_PROTOCOL_VERSION = 11  # Go reference: version/version.go Block=11


@dataclass
class State:
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time: int  # ns
    next_validators: ValidatorSet
    validators: ValidatorSet
    last_validators: ValidatorSet
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_height_consensus_params_changed: int
    last_results_hash: bytes
    app_hash: bytes
    app_version: int = 0

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.copy(),
            validators=self.validators.copy(),
            last_validators=self.last_validators.copy(),
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=_copy.deepcopy(self.consensus_params),
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            app_version=self.app_version,
        )

    def is_empty(self) -> bool:
        return len(self.validators) == 0

    # -- block construction (Go reference: state/state.go MakeBlock) --

    def make_block(self, height: int, txs: list[bytes], commit: Commit | None,
                   evidence: list, proposer_address: bytes,
                   time_ns: int) -> Block:
        data = Data(list(txs))
        ev = EvidenceData(list(evidence))
        header = Header(
            version_block=BLOCK_PROTOCOL_VERSION,
            version_app=self.app_version,
            chain_id=self.chain_id,
            height=height,
            time=time_ns,
            last_block_id=self.last_block_id,
            last_commit_hash=commit.hash() if commit is not None else b"",
            data_hash=data.hash(),
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=ev.hash(),
            proposer_address=proposer_address,
        )
        return Block(header, data, ev, commit)


def make_genesis_state(gdoc: GenesisDoc) -> State:
    """Go reference: state/state.go MakeGenesisState."""
    gdoc.validate_and_complete()
    if gdoc.validators:
        vals = ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in gdoc.validators]
        )
        next_vals = vals.copy()
        next_vals.increment_proposer_priority(1)
    else:
        vals = ValidatorSet([])  # valset arrives from InitChain
        next_vals = ValidatorSet([])
    return State(
        chain_id=gdoc.chain_id,
        initial_height=gdoc.initial_height,
        last_block_height=0,
        last_block_id=NIL_BLOCK_ID,
        last_block_time=gdoc.genesis_time,
        next_validators=next_vals,
        validators=vals,
        last_validators=ValidatorSet([]),
        last_height_validators_changed=gdoc.initial_height,
        consensus_params=gdoc.consensus_params,
        last_height_consensus_params_changed=gdoc.initial_height,
        last_results_hash=b"",
        app_hash=gdoc.app_hash,
        app_version=gdoc.consensus_params.version.app_version,
    )


def abci_results_hash(deliver_tx_responses: list) -> bytes:
    """Merkle root of deterministic (code, data) per DeliverTx result
    (Go reference: types/results.go ABCIResults.Hash). Takes any objects
    with `code` and `data`: the port has no ABCI types yet."""
    leaves = []
    for r in deliver_tx_responses:
        w = Writer()
        w.varint(1, r.code)
        w.bytes(2, r.data)
        leaves.append(w.finish())
    return merkle.hash_from_byte_slices(leaves)


def median_time(commit: Commit, validators: ValidatorSet) -> int:
    """Voting-power-weighted median of commit timestamps — BFT time
    (Go reference: types/validator_set.go weightedMedian)."""
    pairs: list[tuple[int, int]] = []  # (timestamp, power)
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is None:
            continue
        pairs.append((cs.timestamp, val.voting_power))
        total += val.voting_power
    pairs.sort()
    half = (total + 1) // 2
    acc = 0
    for ts, power in pairs:
        acc += power
        if acc >= half:
            return ts
    return 0
