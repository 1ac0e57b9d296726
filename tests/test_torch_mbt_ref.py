"""The port's adapter for the Go reference's light-client MBT corpus
(tendermint_tpu_torch/light/mbt_ref.py) against the JAX package's
(tendermint_tpu/light/mbt_ref.py).

The TLA+ corpus is not on this machine, so the case files are written
here in its schema (tmjson: string int64s, base64 keys and signatures,
hex hashes, RFC3339 times with nanoseconds), from seeded keys signing
the reference's canonical sign bytes: a SUCCESS chain (adjacent and
skipping steps), NOT_ENOUGH_TRUST after a swap of 3/4 of the power, a
tampered signature, an expired trusting period, and a header 1 s + 1
ns ahead of `now` (past MAX_CLOCK_DRIFT_NS; 1 s - 1 ns passes).
run_case and run_case_file give equal verdict lists in both packages,
equal to the fixtures' own, and the same AssertionError where a
fixture's expected verdict is wrong."""

import base64
import copy
import datetime
import hashlib
import json

import pytest

from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.crypto import ed25519_ref
from tendermint_tpu.light import mbt_ref as ref_mbt
from tendermint_tpu.types.block import (
    BlockID, BlockIDFlag, Commit, CommitSig, Header, PartSetHeader,
)
from tendermint_tpu.types.validator import Validator
from tendermint_tpu.types.validator_set import ValidatorSet
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.light import mbt_ref

CHAIN = "mbt-ref-chain"
T0 = 1_700_000_000 * 10**9
SEC = 10**9
PERIOD = 3600 * SEC


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def seed(tag: str, i: int) -> bytes:
    return hashlib.sha256(b"mbt-ref-%s-%d" % (tag.encode(), i)).digest()


def valset(seeds):
    vs = ValidatorSet([Validator.new(jed25519.Ed25519PubKey(
        ed25519_ref.public_key_from_seed(s)), 10) for s in seeds])
    by_pub = {ed25519_ref.public_key_from_seed(s): s for s in seeds}
    return vs, by_pub


def rfc3339(ns: int) -> str:
    dt = datetime.datetime.fromtimestamp(ns // SEC, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S") + f".{ns % SEC:09d}Z"


def bid_json(bid):
    return {"hash": bid.hash.hex().upper(),
            "part_set_header": {"total": bid.part_set_header.total,
                                "hash": bid.part_set_header.hash.hex()
                                .upper()}}


def vals_json(vs):
    return {"validators": [
        {"address": v.address.hex().upper(),
         "pub_key": {"type": "tendermint/PubKeyEd25519",
                     "value": base64.b64encode(v.pub_key.bytes()).decode()},
         "voting_power": str(v.voting_power),
         "proposer_priority": str(v.proposer_priority)}
        for v in vs.validators]}


def signed_header(height: int, vs, by_pub, next_vs, time_ns: int):
    """A header at `height` signed by every validator of `vs`, in the
    corpus's JSON."""
    h = Header(
        version_block=11, version_app=0, chain_id=CHAIN, height=height,
        time=time_ns,
        last_block_id=BlockID(hashlib.sha256(b"last%d" % height).digest(),
                              PartSetHeader(1, b"\x01" * 32)),
        last_commit_hash=hashlib.sha256(b"lc%d" % height).digest(),
        data_hash=hashlib.sha256(b"").digest(),
        validators_hash=vs.hash(), next_validators_hash=next_vs.hash(),
        consensus_hash=hashlib.sha256(b"cp").digest(),
        app_hash=hashlib.sha256(b"app%d" % height).digest(),
        last_results_hash=hashlib.sha256(b"").digest(),
        evidence_hash=hashlib.sha256(b"").digest(),
        proposer_address=vs.validators[0].address)
    bid = BlockID(h.hash(), PartSetHeader(1, b"\x02" * 32))
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address, time_ns + i, b"")
            for i, v in enumerate(vs.validators)]
    commit = Commit(height, 0, bid, sigs)
    for i, v in enumerate(vs.validators):
        sigs[i].signature = ed25519_ref.sign(
            by_pub[v.pub_key.bytes()], commit.vote_sign_bytes(CHAIN, i))
    header = {
        "version": {"block": "11", "app": "0"}, "chain_id": CHAIN,
        "height": str(height), "time": rfc3339(time_ns),
        "last_block_id": bid_json(h.last_block_id),
        **{k: getattr(h, k).hex().upper() for k in (
            "last_commit_hash", "data_hash", "validators_hash",
            "next_validators_hash", "consensus_hash", "app_hash",
            "last_results_hash", "evidence_hash", "proposer_address")}}
    return {"header": header, "commit": {
        "height": str(height), "round": 0, "block_id": bid_json(bid),
        "signatures": [{"block_id_flag": int(BlockIDFlag.COMMIT),
                        "validator_address": s.validator_address.hex()
                        .upper(),
                        "timestamp": rfc3339(s.timestamp),
                        "signature": base64.b64encode(s.signature)
                        .decode()} for s in sigs]}}


def step(height, vs, by_pub, next_vs, now_ns, verdict, time_ns=None):
    t = T0 + height * SEC if time_ns is None else time_ns
    return {"block": {"signed_header": signed_header(height, vs, by_pub,
                                                     next_vs, t),
                      "validator_set": vals_json(vs),
                      "next_validator_set": vals_json(next_vs)},
            "now": rfc3339(now_ns), "verdict": verdict}


def case(description: str, steps, vs, by_pub, period=PERIOD):
    return {"description": description,
            "initial": {"signed_header": signed_header(1, vs, by_pub, vs,
                                                       T0 + SEC),
                        "next_validator_set": vals_json(vs),
                        "trusting_period": str(period),
                        "now": rfc3339(T0 + 2 * SEC)},
            "input": steps}


def cases() -> dict:
    vs, by_pub = valset([seed("a", i) for i in range(4)])
    # 3/4 of the power swapped out: the trusted set signs < 1/3
    ws, w_pub = valset([seed("a", 0)] + [seed("b", i) for i in range(3)])
    now = T0 + 100 * SEC
    tampered = step(2, vs, by_pub, vs, now, "INVALID")
    sig0 = tampered["block"]["signed_header"]["commit"]["signatures"][0]
    raw = bytearray(base64.b64decode(sig0["signature"]))
    raw[5] ^= 0x01
    sig0["signature"] = base64.b64encode(bytes(raw)).decode()
    return {
        "success_chain": case("adjacent and skipping steps", [
            step(2, vs, by_pub, vs, now, "SUCCESS"),
            step(3, vs, by_pub, vs, now, "SUCCESS"),
            step(6, vs, by_pub, vs, now, "SUCCESS")], vs, by_pub),
        "not_enough_trust": case("3/4 of the power swapped", [
            step(4, ws, w_pub, ws, now, "NOT_ENOUGH_TRUST"),
            step(2, vs, by_pub, vs, now, "SUCCESS")], vs, by_pub),
        "tampered_signature": case("one signature byte flipped", [
            tampered, step(2, vs, by_pub, vs, now, "SUCCESS")], vs, by_pub),
        "expired": case("the trusted header outlived its period", [
            step(2, vs, by_pub, vs, T0 + SEC + 60 * SEC, "INVALID")],
            vs, by_pub, period=30 * SEC),
        "clock_drift": case("a header 1 s + 1 ns ahead of now", [
            step(2, vs, by_pub, vs, T0 + 5 * SEC, "INVALID",
                 time_ns=T0 + 6 * SEC + 1),
            step(2, vs, by_pub, vs, T0 + 5 * SEC, "SUCCESS",
                 time_ns=T0 + 6 * SEC - 1)], vs, by_pub),
    }


CASES = cases()
WANT = {name: [s["verdict"] for s in doc["input"]]
        for name, doc in CASES.items()}


def test_the_cases_cover_every_verdict():
    assert {v for vs in WANT.values() for v in vs} == {
        mbt_ref.SUCCESS, mbt_ref.NOT_ENOUGH_TRUST, mbt_ref.INVALID}
    assert mbt_ref.MAX_CLOCK_DRIFT_NS == ref_mbt.MAX_CLOCK_DRIFT_NS == SEC


@pytest.mark.parametrize("name", sorted(CASES))
def test_verdicts_equal_in_both_packages(name, tmp_path):
    doc = CASES[name]
    assert mbt_ref.run_case(copy.deepcopy(doc)) == WANT[name]
    assert ref_mbt.run_case(copy.deepcopy(doc)) == WANT[name]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(doc))
    assert mbt_ref.run_case_file(str(path)) == \
        ref_mbt.run_case_file(str(path)) == WANT[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_wrong_expected_verdict_raises_the_same_assertion(name):
    doc = copy.deepcopy(CASES[name])
    last = doc["input"][-1]
    last["verdict"] = ("INVALID" if last["verdict"] != "INVALID"
                       else "SUCCESS")
    with pytest.raises(AssertionError) as port_err:
        mbt_ref.run_case(copy.deepcopy(doc))
    with pytest.raises(AssertionError) as ref_err:
        ref_mbt.run_case(copy.deepcopy(doc))
    assert str(port_err.value) == str(ref_err.value)
    assert doc["description"] in str(port_err.value)


def test_a_key_that_is_not_ed25519_is_refused_alike():
    doc = copy.deepcopy(CASES["success_chain"])
    doc["input"][0]["block"]["validator_set"]["validators"][0]["pub_key"][
        "type"] = "tendermint/PubKeySecp256k1"
    with pytest.raises(ValueError) as port_err:
        mbt_ref.run_case(doc)
    with pytest.raises(ValueError) as ref_err:
        ref_mbt.run_case(copy.deepcopy(doc))
    assert str(port_err.value) == str(ref_err.value)
