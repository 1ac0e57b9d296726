"""Consensus messages (reference: consensus/messages.py; Go
consensus/msgs.go proto codec).

Wire form: a one-byte type tag + a payload. Votes/proposals ride their
canonical proto encodings (types/vote.py, types/proposal.py); block
parts carry their merkle proof inline. The same codec serves the WAL
and, with the p2p port, the consensus reactor channels. The bytes are
equal to the reference's, message for message."""

from __future__ import annotations

from dataclasses import dataclass

from ..types.block import BlockID, Part, block_id_writer, read_block_id
from ..encoding.proto import Reader, Writer
from ..libs.bits import BitArray
from ..types.proposal import Proposal
from ..types.vote import Vote


@dataclass
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = 0


@dataclass
class NewValidBlockMessage:
    height: int
    round: int
    block_parts_header: object  # PartSetHeader
    block_parts: BitArray
    is_commit: bool


@dataclass
class ProposalMessage:
    proposal: Proposal
    # Optional cross-node trace context (the reference's libs/tracing.py
    # origin tag; the port carries it and does not read it): opaque on
    # the wire, skipped by decoders that predate it. Rides
    # the three block-lifecycle messages only (Proposal/BlockPart/Vote).
    origin: bytes | None = None


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part
    origin: bytes | None = None


@dataclass
class VoteMessage:
    vote: Vote
    origin: bytes | None = None


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID
    votes: BitArray


# --- wire codec --------------------------------------------------------------

_TAG = {
    NewRoundStepMessage: 1,
    NewValidBlockMessage: 2,
    ProposalMessage: 3,
    ProposalPOLMessage: 4,
    BlockPartMessage: 5,
    VoteMessage: 6,
    HasVoteMessage: 7,
    VoteSetMaj23Message: 8,
    VoteSetBitsMessage: 9,
}
_BY_TAG = {v: k for k, v in _TAG.items()}


def _bits_writer(b: BitArray) -> Writer:
    w = Writer()
    w.varint(1, b.size)
    w.bytes(2, b.to_bytes())
    return w


def _read_bits(data: bytes) -> BitArray:
    r = Reader(data)
    size, raw = 0, b""
    while not r.at_end():
        f, wt = r.field()
        if f == 1:
            size = r.varint()
        elif f == 2:
            raw = r.bytes()
        else:
            r.skip(wt)
    return BitArray.from_bytes(size, raw)


def _part_writer(p: Part) -> Writer:
    return p.to_proto()


def _read_part(data: bytes) -> Part:
    return Part.from_bytes(data)


def encode_consensus_msg(msg) -> bytes:
    tag = _TAG[type(msg)]
    w = Writer()
    if isinstance(msg, NewRoundStepMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        w.varint(3, msg.step)
        w.varint(4, msg.seconds_since_start_time)
        w.varint(5, msg.last_commit_round)
    elif isinstance(msg, NewValidBlockMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        ph = Writer()
        ph.varint(1, msg.block_parts_header.total)
        ph.bytes(2, msg.block_parts_header.hash)
        w.message(3, ph)
        w.message(4, _bits_writer(msg.block_parts))
        w.bool(5, msg.is_commit)
    elif isinstance(msg, ProposalMessage):
        w.message(1, msg.proposal.to_proto())
        if msg.origin:
            w.bytes(15, msg.origin)
    elif isinstance(msg, ProposalPOLMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.proposal_pol_round, skip_zero=False)
        w.message(3, _bits_writer(msg.proposal_pol))
    elif isinstance(msg, BlockPartMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        w.message(3, _part_writer(msg.part))
        if msg.origin:
            w.bytes(15, msg.origin)
    elif isinstance(msg, VoteMessage):
        w.message(1, msg.vote.to_proto())
        if msg.origin:
            w.bytes(15, msg.origin)
    elif isinstance(msg, HasVoteMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        w.varint(3, msg.type)
        w.varint(4, msg.index, skip_zero=False)
    elif isinstance(msg, VoteSetMaj23Message):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        w.varint(3, msg.type)
        w.message(4, block_id_writer(msg.block_id))
    elif isinstance(msg, VoteSetBitsMessage):
        w.varint(1, msg.height)
        w.varint(2, msg.round, skip_zero=False)
        w.varint(3, msg.type)
        w.message(4, block_id_writer(msg.block_id))
        w.message(5, _bits_writer(msg.votes))
    return bytes([tag]) + w.finish()


def decode_consensus_msg(data: bytes):
    if not data:
        raise ValueError("empty consensus message")
    cls = _BY_TAG.get(data[0])
    if cls is None:
        raise ValueError(f"unknown consensus message tag {data[0]}")
    r = Reader(data[1:])
    if cls is NewRoundStepMessage:
        kw = dict(height=0, round=0, step=0, seconds_since_start_time=0,
                  last_commit_round=0)
        names = {1: "height", 2: "round", 3: "step",
                 4: "seconds_since_start_time", 5: "last_commit_round"}
        while not r.at_end():
            f, wt = r.field()
            if f in names:
                kw[names[f]] = r.varint()
            else:
                r.skip(wt)
        return cls(**kw)
    if cls is NewValidBlockMessage:
        from ..types.block import PartSetHeader

        height = round_ = 0
        psh = PartSetHeader(0, b"")
        bits = BitArray(0)
        is_commit = False
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                round_ = r.varint()
            elif f == 3:
                rr = Reader(r.bytes())
                total, h = 0, b""
                while not rr.at_end():
                    ff, wwt = rr.field()
                    if ff == 1:
                        total = rr.varint()
                    elif ff == 2:
                        h = rr.bytes()
                    else:
                        rr.skip(wwt)
                psh = PartSetHeader(total, h)
            elif f == 4:
                bits = _read_bits(r.bytes())
            elif f == 5:
                is_commit = bool(r.varint())
            else:
                r.skip(wt)
        return cls(height, round_, psh, bits, is_commit)
    if cls is ProposalMessage:
        prop = None
        origin = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                prop = Proposal.from_bytes(r.bytes())
            elif f == 15:
                origin = r.bytes()
            else:
                r.skip(wt)
        if prop is None:
            raise ValueError("ProposalMessage without a proposal")
        return cls(prop, origin=origin)
    if cls is ProposalPOLMessage:
        height = pol_round = 0
        bits = BitArray(0)
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                pol_round = r.varint()
            elif f == 3:
                bits = _read_bits(r.bytes())
            else:
                r.skip(wt)
        return cls(height, pol_round, bits)
    if cls is BlockPartMessage:
        height = round_ = 0
        part = None
        origin = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                round_ = r.varint()
            elif f == 3:
                part = _read_part(r.bytes())
            elif f == 15:
                origin = r.bytes()
            else:
                r.skip(wt)
        if part is None:
            raise ValueError("BlockPartMessage without a part")
        return cls(height, round_, part, origin=origin)
    if cls is VoteMessage:
        vote = None
        origin = None
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                vote = Vote.from_bytes(r.bytes())
            elif f == 15:
                origin = r.bytes()
            else:
                r.skip(wt)
        if vote is None:
            raise ValueError("VoteMessage without a vote")
        return cls(vote, origin=origin)
    if cls is HasVoteMessage:
        kw = dict(height=0, round=0, type=0, index=0)
        names = {1: "height", 2: "round", 3: "type", 4: "index"}
        while not r.at_end():
            f, wt = r.field()
            if f in names:
                kw[names[f]] = r.varint()
            else:
                r.skip(wt)
        return cls(**kw)
    if cls is VoteSetMaj23Message:
        height = round_ = type_ = 0
        bid = BlockID(b"", None)
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                round_ = r.varint()
            elif f == 3:
                type_ = r.varint()
            elif f == 4:
                bid = read_block_id(r.bytes())
            else:
                r.skip(wt)
        return cls(height, round_, type_, bid)
    if cls is VoteSetBitsMessage:
        height = round_ = type_ = 0
        bid = BlockID(b"", None)
        bits = BitArray(0)
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                height = r.varint()
            elif f == 2:
                round_ = r.varint()
            elif f == 3:
                type_ = r.varint()
            elif f == 4:
                bid = read_block_id(r.bytes())
            elif f == 5:
                bits = _read_bits(r.bytes())
            else:
                r.skip(wt)
        return cls(height, round_, type_, bid, bits)
    raise AssertionError("unreachable")
