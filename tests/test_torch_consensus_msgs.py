"""The port's consensus wire codec (consensus/messages.py) against the
JAX package's: for each of the nine messages, seeded contents built in
both packages encode to equal bytes, each package decodes the other's
bytes to equal fields (and re-encodes them to the same bytes), and
malformed or truncated inputs end the same way in both: the same
exception class, or equal decoded fields. Tolerance: exact."""

import dataclasses
import enum
import hashlib
import importlib
import types

import numpy as np
import pytest

MODULES = dict(msgs="consensus.messages", block="types.block",
               vote="types.vote", proposal="types.proposal", bits="libs.bits")


def _namespace(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")

KINDS = ("NewRoundStepMessage", "NewValidBlockMessage", "ProposalMessage",
         "ProposalPOLMessage", "BlockPartMessage", "VoteMessage",
         "HasVoteMessage", "VoteSetMaj23Message", "VoteSetBitsMessage")


def norm(x):
    """A package-free form of a decoded message's fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if type(x).__name__ == "BitArray":
        return ("BitArray", x.size, x.to_bytes())
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if x is None or isinstance(x, (bytes, bool, int, str, float)):
        return x
    raise TypeError(f"cannot normalize {type(x).__name__}")


def outcome(fn):
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raise", type(e).__name__)


def build(p, kind: str, rng: np.random.Generator, edge: bool = False):
    """A message of `kind` from package p, its contents drawn from rng;
    `edge` zeroes every round and index (fields proto3 would skip)."""
    def rb(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def bits(n):
        ba = p.bits.BitArray(n)
        for i in np.flatnonzero(rng.integers(0, 2, n)):
            ba.set(int(i), True)
        return ba

    h, r = int(rng.integers(1, 10**6)), int(rng.integers(0, 5))
    r = 0 if edge else r
    index = 0 if edge else int(rng.integers(0, 10_000))
    psh = p.block.PartSetHeader(int(rng.integers(1, 8)), rb(32))
    bid = p.block.BlockID(rb(32), psh)
    ts = int(rng.integers(1, 2**62))
    M = p.msgs
    if kind == "NewRoundStepMessage":
        return M.NewRoundStepMessage(h, r, int(rng.integers(1, 9)),
                                     int(rng.integers(0, 100)),
                                     int(rng.integers(0, 3)))
    if kind == "NewValidBlockMessage":
        return M.NewValidBlockMessage(h, r, psh, bits(int(rng.integers(1, 70))),
                                      bool(rng.integers(0, 2)))
    if kind == "ProposalMessage":
        prop = p.proposal.Proposal(height=h, round=r, pol_round=r - 1,
                                   block_id=bid, timestamp=ts)
        prop.signature = rb(64)
        return M.ProposalMessage(prop, origin=rb(12))
    if kind == "ProposalPOLMessage":
        return M.ProposalPOLMessage(h, r, bits(int(rng.integers(1, 150))))
    if kind == "BlockPartMessage":
        ps = p.block.PartSet.from_data(rb(int(rng.integers(70_000, 140_000))))
        return M.BlockPartMessage(h, r, ps.get_part(int(rng.integers(0, ps.total))))
    if kind == "VoteMessage":
        v = p.vote.Vote(type=p.vote.VoteType(int(rng.integers(1, 3))),
                        height=h, round=r,
                        block_id=bid if rng.integers(0, 2) else None,
                        timestamp=ts, validator_address=rb(20),
                        validator_index=index,
                        signature=rb(64))
        return M.VoteMessage(v)
    if kind == "HasVoteMessage":
        return M.HasVoteMessage(h, r, int(rng.integers(1, 3)), index)
    if kind == "VoteSetMaj23Message":
        return M.VoteSetMaj23Message(h, r, int(rng.integers(1, 3)), bid)
    return M.VoteSetBitsMessage(h, r, int(rng.integers(1, 3)), bid,
                                bits(int(rng.integers(1, 200))))


def seeded(kind: str, i: int) -> int:
    return int.from_bytes(hashlib.sha256(f"{kind}-{i}".encode()).digest()[:8],
                          "big")


@pytest.mark.parametrize("kind", KINDS)
def test_message_bytes_equal_reference_and_cross_decode(kind):
    for i in range(4):
        pm = build(PORT, kind, np.random.default_rng(seeded(kind, i)), i == 0)
        rm = build(REF, kind, np.random.default_rng(seeded(kind, i)), i == 0)
        pb = PORT.msgs.encode_consensus_msg(pm)
        rb = REF.msgs.encode_consensus_msg(rm)
        assert pb == rb and pb[0] == KINDS.index(kind) + 1
        from_ref = PORT.msgs.decode_consensus_msg(rb)
        from_port = REF.msgs.decode_consensus_msg(pb)
        assert type(from_ref).__name__ == type(from_port).__name__ == kind
        assert norm(from_ref) == norm(from_port)
        assert PORT.msgs.encode_consensus_msg(from_ref) == rb
        assert REF.msgs.encode_consensus_msg(from_port) == pb


@pytest.mark.parametrize("kind", KINDS)
def test_malformed_and_truncated_inputs_end_the_same(kind):
    rng = np.random.default_rng(seeded(kind, 99))
    raw = REF.msgs.encode_consensus_msg(build(REF, kind, rng))
    cases = [b"", bytes([0]), bytes([10]), raw[:1], raw + b"\x08",
             raw[:1] + b"\xff" * 3]
    cases += [raw[:n] for n in sorted({2, 3, len(raw) // 2, len(raw) - 1})
              if 0 < n < len(raw)]
    for pos in rng.integers(1, len(raw), 6):
        flipped = bytearray(raw)
        flipped[pos] ^= 0xFF
        cases.append(bytes(flipped))
    for case in cases:
        got = outcome(lambda: PORT.msgs.decode_consensus_msg(case))
        want = outcome(lambda: REF.msgs.decode_consensus_msg(case))
        assert got == want, case.hex()
