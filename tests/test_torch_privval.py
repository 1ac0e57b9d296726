"""The port's FilePV (privval/file_pv.py) against the JAX package's: key
and last-sign-state files written by one package load in the other, byte
for byte the same files; one script of sign_vote / sign_proposal calls
(new HRS, the same bytes again, a re-sign differing only in its
timestamp, double signs, height/round/step regressions) gives equal
signatures, timestamps, refusals (class and text) and state files after
every call; and an error at the `privval.save` failpoint between signing
and persisting lets no signature escape, in both packages, as in the
reference's tests/test_privval.py:91. Tolerance: exact."""

import hashlib
import importlib
import json
import types

import pytest

MODULES = dict(fpv="privval.file_pv", ed="crypto.ed25519", vote="types.vote",
               proposal="types.proposal", block="types.block",
               failpoints="libs.failpoints")


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})
    ns.name = root
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")
CHAIN = "torch-privval-chain"
SEED = hashlib.sha256(b"privval-key").digest()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for p in (PORT, REF):
        p.failpoints.disarm_all()


def bid(p, i: int):
    return p.block.BlockID(bytes([i]) * 32, p.block.PartSetHeader(1, bytes([i + 1]) * 32))


def vote(p, h, r, type_=1, b=1, ts=1000):
    return p.vote.Vote(type=p.vote.VoteType(type_), height=h, round=r,
                       block_id=bid(p, b) if b else None, timestamp=ts,
                       validator_address=b"\x07" * 20, validator_index=0)


def proposal(p, h, r, b=1, ts=2000, pol=-1):
    return p.proposal.Proposal(height=h, round=r, pol_round=pol,
                               block_id=bid(p, b), timestamp=ts)


def make_pv(p, d):
    pv = p.fpv.FilePV(p.ed.Ed25519PrivKey(SEED), str(d / "key.json"),
                      str(d / "state.json"))
    pv.save_key()
    return pv


# (operation, args): each is applied to both packages' FilePV in turn
SCRIPT = [
    ("vote", (1, 0)),                      # new HRS
    ("vote", (1, 0)),                      # the same bytes: the saved sig
    ("vote", (1, 0, 1, 1, 424242)),        # only the timestamp differs
    ("vote", (1, 0, 1, 9)),                # double sign: refused
    ("vote", (1, 0, 2)),                   # precommit, same h/r
    ("vote", (1, 0, 1)),                   # step regression
    ("proposal", (2, 0)),
    ("proposal", (2, 0, 1, 777)),          # only the timestamp differs
    ("proposal", (2, 0, 3)),               # double proposal: refused
    ("vote", (2, 3)),
    ("vote", (2, 1)),                      # round regression
    ("vote", (1, 5)),                      # height regression
    ("vote", (3, 0, 2, 0)),                # a nil precommit
    ("vote", (3, 0, 2, 0, 55)),            # nil, only the timestamp
]


def run_script(p, d):
    pv = make_pv(p, d)
    out = []
    for op, args in SCRIPT:
        msg = vote(p, *args) if op == "vote" else proposal(p, *args)
        sign = pv.sign_vote if op == "vote" else pv.sign_proposal
        try:
            sign(CHAIN, msg)
            got = ("ok", msg.signature, msg.timestamp)
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            got = (type(e).__name__, str(e))
        with open(d / "state.json", "rb") as f:
            out.append((got, f.read()))
    return out


def test_sign_script_equals_reference(tmp_path):
    (tmp_path / "r").mkdir(), (tmp_path / "p").mkdir()
    want = run_script(REF, tmp_path / "r")
    got = run_script(PORT, tmp_path / "p")
    assert got == want
    outcomes = [g for g, _ in got]
    assert outcomes[1][1] == outcomes[0][1]
    assert outcomes[2][1:] == outcomes[0][1:]          # rewound to ts 1000
    assert outcomes[3] == ("RemoteSignError", "conflicting data at 1/0/2: "
                           "refusing to double-sign")
    assert outcomes[5][0] == outcomes[8][0] == outcomes[10][0] == \
        outcomes[11][0] == "RemoteSignError"


def test_key_and_state_files_interchange(tmp_path):
    """Files one package writes are the other's bytes and load there:
    the same key, the same last-sign state, and the loaded FilePV keeps
    refusing a double sign the writer signed."""
    for writer, reader in ((REF, PORT), (PORT, REF)):
        d = tmp_path / writer.name
        d.mkdir()
        pv = make_pv(writer, d)
        pv.sign_vote(CHAIN, vote(writer, 4, 1))
        other = tmp_path / f"{writer.name}-other"
        other.mkdir()
        twin = make_pv(reader, other)
        twin.sign_vote(CHAIN, vote(reader, 4, 1))
        for name in ("key.json", "state.json"):
            assert (d / name).read_bytes() == (other / name).read_bytes()
        loaded = reader.fpv.FilePV.load(str(d / "key.json"),
                                        str(d / "state.json"))
        assert loaded.get_pub_key().bytes() == pv.get_pub_key().bytes()
        lss, want = loaded.last_sign_state, pv.last_sign_state
        assert (lss.height, lss.round, lss.step, lss.signature,
                lss.sign_bytes) == (want.height, want.round, want.step,
                                    want.signature, want.sign_bytes)
        with pytest.raises(reader.fpv.RemoteSignError, match="double-sign"):
            loaded.sign_vote(CHAIN, vote(reader, 4, 1, b=5))
        v = vote(reader, 4, 1, ts=99)
        loaded.sign_vote(CHAIN, v)
        assert v.signature == want.signature and v.timestamp == 1000


def test_reference_tmjson_files_load(tmp_path):
    """The Go reference's tmjson key and state forms load in both."""
    import base64

    key = REF.ed.Ed25519PrivKey(SEED)
    (tmp_path / "key.json").write_text(json.dumps({"priv_key": {
        "type": "tendermint/PrivKeyEd25519",
        "value": base64.b64encode(key.bytes()).decode()}}))
    (tmp_path / "state.json").write_text(json.dumps({
        "height": "7", "round": 1, "step": 2,
        "signature": base64.b64encode(b"\x01" * 64).decode(),
        "signbytes": "0a0b"}))
    loaded = [p.fpv.FilePV.load(str(tmp_path / "key.json"),
                                str(tmp_path / "state.json"))
              for p in (REF, PORT)]
    assert loaded[0].get_pub_key().bytes() == loaded[1].get_pub_key().bytes()
    assert [vars(pv.last_sign_state) for pv in loaded][0] == \
        vars(loaded[1].last_sign_state)


def test_crash_between_sign_and_persist_survives(tmp_path):
    """An error at privval.save: the signature does not escape and the
    in-memory state stays at the persisted HRS; after a restart the
    persisted HRS still refuses a double sign and the crashed vote signs
    afresh — the same in both packages."""
    def go(p, d):
        pv = make_pv(p, d)
        pv.sign_vote(CHAIN, vote(p, 1, 0))
        p.failpoints.arm("privval.save", "error")
        v2 = vote(p, 1, 0, type_=2)
        try:
            with pytest.raises(p.failpoints.FailpointError):
                pv.sign_vote(CHAIN, v2)
        finally:
            p.failpoints.disarm_all()
        lss = pv.last_sign_state
        mem = (v2.signature, lss.height, lss.round, lss.step)
        pv2 = p.fpv.FilePV.load(str(d / "key.json"), str(d / "state.json"))
        lss = pv2.last_sign_state
        with pytest.raises(p.fpv.RemoteSignError, match="double-sign"):
            pv2.sign_vote(CHAIN, vote(p, 1, 0, b=9))
        v3 = vote(p, 1, 0, type_=2)
        pv2.sign_vote(CHAIN, v3)
        return mem, (lss.height, lss.round, lss.step), v3.signature

    (tmp_path / "r").mkdir(), (tmp_path / "p").mkdir()
    want = go(REF, tmp_path / "r")
    got = go(PORT, tmp_path / "p")
    assert got == want
    assert got[0] == (b"", 1, 0, 2) and got[1] == (1, 0, 2) and got[2]
