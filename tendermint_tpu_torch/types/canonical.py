"""Canonical sign-bytes (reference: types/canonical.go).

The bytes a validator signs for votes and proposals. Deterministic
protobuf wire encoding, length-delimited (varint length prefix), field
numbers and types mirroring the reference's canonical.proto:

  CanonicalVote     { type=1 varint; height=2 sfixed64; round=3 sfixed64;
                      block_id=4; timestamp=5; chain_id=6 }
  CanonicalProposal { type=1; height=2 sfixed64; round=3 sfixed64;
                      pol_round=4 varint; block_id=5; timestamp=6;
                      chain_id=7 }
  CanonicalBlockID  { hash=1; part_set_header=2 }
  CanonicalPartSetHeader { total=1 varint; hash=2 }
  Timestamp         { seconds=1 varint; nanos=2 varint }

Zero-valued scalars are skipped (proto3 canonical form); a nil BlockID
encodes as an absent field.
"""

from __future__ import annotations

from ..encoding.proto import Writer, encode_varint


def timestamp_writer(time_ns: int) -> Writer | None:
    if time_ns == 0:
        return None
    w = Writer()
    w.varint(1, time_ns // 1_000_000_000)
    w.varint(2, time_ns % 1_000_000_000)
    return w


def canonical_block_id_writer(block_id) -> Writer | None:
    """block_id: types.block.BlockID or None. CanonicalizeBlockID
    returns nil for a ZERO block id (field omitted — nil votes), where
    zero is the reference's IsZero: empty hash AND zero
    part_set_header — NOT is_nil()'s hash-only check (an empty-hash
    BlockID with a real part-set header still canonicalizes, keeping
    sign bytes byte-identical with the reference). A present
    CanonicalBlockID always carries its part_set_header: the field is
    gogoproto nullable=false (canonical.proto:12), so the reference
    emits it even when empty."""
    if block_id is None or block_id.is_zero():
        return None
    w = Writer()
    w.bytes(1, block_id.hash)
    pw = Writer()
    psh = block_id.part_set_header
    if psh is not None:
        pw.varint(1, psh.total)
        pw.bytes(2, psh.hash)
    w.message(2, pw)
    return w


def vote_sign_bytes(chain_id: str, vote_type: int, height: int, round_: int,
                    block_id, time_ns: int) -> bytes:
    w = Writer()
    w.varint(1, vote_type)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.message(4, canonical_block_id_writer(block_id))
    w.message(5, timestamp_writer(time_ns))
    w.string(6, chain_id)
    body = w.finish()
    return encode_varint(len(body)) + body


def vote_sign_parts(chain_id: str, vote_type: int, height: int,
                    round_: int, block_id) -> tuple[bytes, bytes]:
    """The timestamp-independent halves of vote sign bytes.

    For ANY time_ns:
        vote_sign_bytes(...) ==
            encode_varint(len(pre) + len(tsf) + len(suf)) + pre + tsf + suf
    with tsf = ts_field_bytes(time_ns). Built with the exact same
    Writer calls as vote_sign_bytes, so the invariant holds by
    construction (tests enforce it across edge cases). Within one
    commit every signature shares (pre, suf) — only the timestamp
    field and the outer length prefix differ per lane — which is what
    lets commit verification ship a template plus per-lane timestamp
    patches to the device instead of full per-lane sign bytes."""
    w = Writer()
    w.varint(1, vote_type)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.message(4, canonical_block_id_writer(block_id))
    pre = w.finish()
    w = Writer()
    w.string(6, chain_id)
    return pre, w.finish()


def ts_field_bytes(time_ns: int) -> bytes:
    """Wire bytes of canonical-vote field 5 (the Timestamp message);
    empty when time_ns == 0 (absent field, proto3 canonical form)."""
    w = Writer()
    w.message(5, timestamp_writer(time_ns))
    return w.finish()


def strip_canonical_timestamp(sign_bytes: bytes, ts_field: int) -> bytes:
    """Re-emit a length-prefixed canonical blob with the timestamp field
    removed — used to decide whether two sign-byte blobs differ only by
    timestamp (reference: privval checkVotesOnlyDifferByTimestamp,
    file.go:413). Wire-level copy; no semantic re-encoding."""
    from ..encoding.proto import Reader, decode_varint

    body_len, pos = decode_varint(sign_bytes, 0)
    body = sign_bytes[pos:pos + body_len]
    if len(body) != body_len:
        raise ValueError("truncated canonical sign bytes")
    r = Reader(body)
    out = bytearray()
    while not r.at_end():
        start = r._pos
        f, wt = r.field()
        r.skip(wt)
        if f != ts_field:
            out += body[start:r._pos]
    return encode_varint(len(out)) + bytes(out)


def extract_canonical_timestamp(sign_bytes: bytes, ts_field: int) -> int:
    """Timestamp (ns) carried inside a canonical sign-bytes blob; 0 if
    the field is absent."""
    from ..encoding.proto import Reader, decode_varint

    body_len, pos = decode_varint(sign_bytes, 0)
    r = Reader(sign_bytes[pos:pos + body_len])
    while not r.at_end():
        f, wt = r.field()
        if f == ts_field and wt == 2:
            tr = Reader(r.bytes())
            secs = nanos = 0
            while not tr.at_end():
                tf, twt = tr.field()
                if tf == 1:
                    secs = tr.varint()
                elif tf == 2:
                    nanos = tr.varint()
                else:
                    tr.skip(twt)
            return secs * 1_000_000_000 + nanos
        r.skip(wt)
    return 0


def proposal_sign_bytes(chain_id: str, height: int, round_: int,
                        pol_round: int, block_id, time_ns: int) -> bytes:
    w = Writer()
    w.varint(1, 32)  # SignedMsgType PROPOSAL
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    # pol_round is -1 when absent; encodes as int64 two's complement.
    w.varint(4, pol_round)
    w.message(5, canonical_block_id_writer(block_id))
    w.message(6, timestamp_writer(time_ns))
    w.string(7, chain_id)
    body = w.finish()
    return encode_varint(len(body)) + body
