"""Signed-transaction envelope codec for the mempool admission plane
(reference: types/tx_envelope.py, byte for byte).

The paper's thesis is that signature verification belongs on the
device in large batches; the consensus commit path already does that,
but CheckTx still round-trips the app per tx. This envelope is the
wire contract that lets the mempool pre-verify tx signatures in
batched device launches BEFORE any ABCI round trip
(mempool/admission.py): a tx that starts with the 4-byte MAGIC is

    MAGIC || proto{1: pub_key (32B ed25519),
                   2: signature (64B over sign_bytes(payload)),
                   3: payload}

and anything else is an UNSIGNED tx, passed through untouched (the
app still sees exactly the bytes the client sent — enveloped txs
reach CheckTx/DeliverTx as the FULL envelope, so the envelope bytes
are the tx identity everywhere: hashes, dedup cache, gossip, blocks).

Bytes that start with MAGIC but do not decode to the three fields are
MALFORMED, not unsigned — otherwise garbage prefixed with the magic
would bypass `mempool.admission = "strict"`.

The signature domain is separated from every consensus signing
context by the SIGN_DOMAIN prefix, so a tx-envelope signature can
never be replayed as (or collide with) a vote/proposal signature and
vice versa.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding.proto import Reader, Writer

# Chosen to be invalid UTF-8 and an impossible protobuf tag start, so
# no plausible text or proto-encoded app payload begins with it by
# accident. An app whose raw (unsigned) txs can legitimately start
# with these bytes must wrap them in envelopes.
MAGIC = b"\xf5\x54\x58\x01"  # 0xF5 'T' 'X' v1

SIGN_DOMAIN = b"tendermint-tpu/tx-envelope/v1\x00"

PUBKEY_SIZE = 32
SIGNATURE_SIZE = 64


class MalformedEnvelopeError(ValueError):
    """MAGIC present but the envelope fields do not decode/size-check."""


@dataclass(frozen=True)
class TxEnvelope:
    pub_key: bytes     # 32-byte ed25519 public key
    signature: bytes   # 64-byte signature over sign_bytes(payload)
    payload: bytes     # the application-level tx bytes


def sign_bytes(payload: bytes) -> bytes:
    """The message actually signed/verified for `payload`."""
    return SIGN_DOMAIN + payload


def encode(pub_key: bytes, signature: bytes, payload: bytes) -> bytes:
    if len(pub_key) != PUBKEY_SIZE:
        raise ValueError(f"pub_key must be {PUBKEY_SIZE} bytes")
    if len(signature) != SIGNATURE_SIZE:
        raise ValueError(f"signature must be {SIGNATURE_SIZE} bytes")
    w = Writer()
    w.bytes(1, pub_key, skip_empty=False)
    w.bytes(2, signature, skip_empty=False)
    w.bytes(3, payload, skip_empty=False)
    return MAGIC + w.finish()


def sign_tx(priv_key, payload: bytes) -> bytes:
    """Wrap `payload` in an envelope signed by `priv_key` (an
    Ed25519PrivKey) — the client-side half of the admission plane."""
    return encode(priv_key.pub_key().bytes(),
                  priv_key.sign(sign_bytes(payload)), payload)


def is_enveloped(tx: bytes) -> bool:
    return tx.startswith(MAGIC)


def parse(tx: bytes) -> TxEnvelope | None:
    """Decode a tx: None for unsigned (no MAGIC), a TxEnvelope for a
    well-formed envelope. Raises MalformedEnvelopeError when the MAGIC
    is present but the body does not decode — malformed is a REJECT
    shape, never a pass-through."""
    if not tx.startswith(MAGIC):
        return None
    pub = sig = payload = None
    try:
        r = Reader(tx[len(MAGIC):])
        while not r.at_end():
            f, wt = r.field()
            if f == 1:
                pub = r.bytes()
            elif f == 2:
                sig = r.bytes()
            elif f == 3:
                payload = r.bytes()
            else:
                r.skip(wt)
    except Exception as e:
        raise MalformedEnvelopeError(f"undecodable envelope: {e}") from e
    if pub is None or sig is None or payload is None:
        raise MalformedEnvelopeError("envelope missing pub/sig/payload")
    if len(pub) != PUBKEY_SIZE:
        raise MalformedEnvelopeError(
            f"envelope pub_key {len(pub)}B != {PUBKEY_SIZE}B")
    if len(sig) != SIGNATURE_SIZE:
        raise MalformedEnvelopeError(
            f"envelope signature {len(sig)}B != {SIGNATURE_SIZE}B")
    return TxEnvelope(pub_key=pub, signature=sig, payload=payload)
