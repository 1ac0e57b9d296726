"""State store (reference: state/store.py; Go state/store.go:74-81).

Persists: the current State, validator sets (a full set a height; the
reference's pruning keeps every VALSET_CHECKPOINT-th, Go
state/store.go:458 lastStoredHeightFor), consensus params and the
per-height ABCI responses (reference :193-225), under the reference's
keys and JSON bytes."""

from __future__ import annotations

import json
import struct

from ..abci import types as abci_types
from ..libs.db import DB
from ..types.block import BlockID, PartSetHeader
from ..types.params import ConsensusParams
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet
from . import State

VALSET_CHECKPOINT = 100000  # Go reference: valSetCheckpointInterval

_STATE_KEY = b"stateKey"


def _h(height: int) -> bytes:
    return struct.pack(">Q", height)


def _valset_to_json(vs: ValidatorSet) -> dict:
    return {
        "validators": [
            {
                "pub_key_type": v.pub_key.type_name,
                "pub_key": v.pub_key.bytes().hex(),
                "power": v.voting_power,
                "priority": v.proposer_priority,
            }
            for v in vs.validators
        ],
        "proposer": vs.proposer.address.hex() if vs.proposer else None,
    }


def _valset_from_json(d: dict) -> ValidatorSet:
    from .. import crypto

    vs = ValidatorSet([])
    for vd in d["validators"]:
        pk = crypto.pubkey_from_type_and_bytes(
            vd["pub_key_type"], bytes.fromhex(vd["pub_key"])
        )
        val = Validator.new(pk, vd["power"])
        val.proposer_priority = vd["priority"]
        vs.validators.append(val)
    if d.get("proposer"):
        _, v = vs.get_by_address(bytes.fromhex(d["proposer"]))
        vs.proposer = v
    return vs


class Store:
    def __init__(self, db: DB):
        self.db = db

    # -- state --

    def save(self, state: State) -> None:
        ops = self._save_ops(state)
        self.db.write_batch(ops)

    def _save_ops(self, state: State) -> list[tuple[bytes, bytes | None]]:
        next_height = state.last_block_height + 1
        if next_height == 1:
            next_height = state.initial_height
            ops = self._valset_ops(next_height, state.validators)
        else:
            ops = []
        ops += self._valset_ops(next_height + 1, state.next_validators)
        ops += self._params_ops(next_height, state.consensus_params,
                                state.last_height_consensus_params_changed)
        ops.append((_STATE_KEY, self._state_bytes(state)))
        return ops

    def _state_bytes(self, state: State) -> bytes:
        bid = state.last_block_id
        return json.dumps({
            "chain_id": state.chain_id,
            "initial_height": state.initial_height,
            "last_block_height": state.last_block_height,
            "last_block_id": {
                "hash": bid.hash.hex(),
                "psh_total": bid.part_set_header.total if bid.part_set_header else 0,
                "psh_hash": bid.part_set_header.hash.hex() if bid.part_set_header else "",
            },
            "last_block_time": state.last_block_time,
            "validators": _valset_to_json(state.validators),
            "next_validators": _valset_to_json(state.next_validators),
            "last_validators": _valset_to_json(state.last_validators),
            "last_height_validators_changed": state.last_height_validators_changed,
            "consensus_params": state.consensus_params.to_json(),
            "last_height_consensus_params_changed":
                state.last_height_consensus_params_changed,
            "last_results_hash": state.last_results_hash.hex(),
            "app_hash": state.app_hash.hex(),
            "app_version": state.app_version,
        }).encode()

    def load(self) -> State | None:
        raw = self.db.get(_STATE_KEY)
        if raw is None:
            return None
        d = json.loads(raw)
        bd = d["last_block_id"]
        psh = (
            PartSetHeader(bd["psh_total"], bytes.fromhex(bd["psh_hash"]))
            if bd["psh_total"] else None
        )
        return State(
            chain_id=d["chain_id"],
            initial_height=d["initial_height"],
            last_block_height=d["last_block_height"],
            last_block_id=BlockID(bytes.fromhex(bd["hash"]), psh),
            last_block_time=d["last_block_time"],
            next_validators=_valset_from_json(d["next_validators"]),
            validators=_valset_from_json(d["validators"]),
            last_validators=_valset_from_json(d["last_validators"]),
            last_height_validators_changed=d["last_height_validators_changed"],
            consensus_params=ConsensusParams.from_json(d["consensus_params"]),
            last_height_consensus_params_changed=
                d["last_height_consensus_params_changed"],
            last_results_hash=bytes.fromhex(d["last_results_hash"]),
            app_hash=bytes.fromhex(d["app_hash"]),
            app_version=d.get("app_version", 0),
        )

    def bootstrap(self, state: State) -> None:
        """Seed the store from an out-of-band trusted state (statesync;
        Go reference state/store.go:188), in ONE batch: a crash cannot
        leave a height with a validator set but no state row, or the
        reverse."""
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height
        ops: list[tuple[bytes, bytes | None]] = []
        if height > 1 and len(state.last_validators):
            ops += self._valset_ops(height - 1, state.last_validators)
        ops += self._valset_ops(height, state.validators)
        ops += self._valset_ops(height + 1, state.next_validators)
        ops += self._params_ops(height, state.consensus_params,
                                state.last_height_consensus_params_changed)
        ops.append((_STATE_KEY, self._state_bytes(state)))
        self.db.write_batch(ops)

    # -- validator sets --

    def _valset_ops(self, height: int, vs: ValidatorSet):
        # every height stores the full set; pruning keeps checkpoints,
        # mirroring the Go reference's recoverability
        return [(b"validatorsKey:" + _h(height),
                 json.dumps(_valset_to_json(vs)).encode())]

    def save_validator_set(self, height: int, vs: ValidatorSet) -> None:
        self.db.write_batch(self._valset_ops(height, vs))

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(b"validatorsKey:" + _h(height))
        if raw is None:
            return None
        return _valset_from_json(json.loads(raw))

    # -- consensus params (with their last-changed height) --

    def _params_ops(self, height: int, params: ConsensusParams,
                    last_changed: int):
        return [(b"consensusParamsKey:" + _h(height),
                 json.dumps({
                     "params": params.to_json(),
                     "last_changed": last_changed,
                 }).encode())]

    def load_consensus_params(self, height: int) -> ConsensusParams | None:
        raw = self.db.get(b"consensusParamsKey:" + _h(height))
        if raw is None:
            return None
        return ConsensusParams.from_json(json.loads(raw)["params"])

    # -- ABCI responses (reference state/store.py:193,212) --

    def save_abci_responses(self, height: int, responses: dict) -> None:
        """responses: {"deliver_txs": [ResponseDeliverTx], "begin_block":
        ResponseBeginBlock, "end_block": ResponseEndBlock}."""
        self.db.set(
            b"abciResponsesKey:" + _h(height),
            json.dumps({
                "deliver_txs": [
                    abci_types.encode_msg(r).decode()
                    for r in responses.get("deliver_txs", [])
                ],
                "begin_block": abci_types.encode_msg(
                    responses["begin_block"]
                ).decode() if responses.get("begin_block") else None,
                "end_block": abci_types.encode_msg(
                    responses["end_block"]
                ).decode() if responses.get("end_block") else None,
            }).encode(),
        )

    def load_abci_responses(self, height: int) -> dict | None:
        raw = self.db.get(b"abciResponsesKey:" + _h(height))
        if raw is None:
            return None
        d = json.loads(raw)
        return {
            "deliver_txs": [
                abci_types.decode_msg(s.encode()) for s in d["deliver_txs"]
            ],
            "begin_block": abci_types.decode_msg(d["begin_block"].encode())
                if d["begin_block"] else None,
            "end_block": abci_types.decode_msg(d["end_block"].encode())
                if d["end_block"] else None,
        }

    # -- pruning (Go reference state/store.go:223) --

    def prune_states(self, from_height: int, to_height: int) -> None:
        if from_height <= 0 or to_height <= from_height:
            return
        ops: list[tuple[bytes, bytes | None]] = []
        for height in range(from_height, to_height):
            if height % VALSET_CHECKPOINT != 0:
                ops.append((b"validatorsKey:" + _h(height), None))
            ops.append((b"consensusParamsKey:" + _h(height), None))
            ops.append((b"abciResponsesKey:" + _h(height), None))
        self.db.write_batch(ops)
