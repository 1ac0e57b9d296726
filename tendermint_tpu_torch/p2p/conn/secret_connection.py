"""Authenticated encrypted connection (reference:
p2p/conn/secret_connection.py; Go p2p/conn/secret_connection.go:63).

Station-to-Station protocol, same structure as the Go reference but a
clean-room redesign (no wire compatibility with Go). The port's
handshake, keys and frames are byte for byte the JAX package's, so a
port node and a reference node connect to each other:

1. exchange ephemeral X25519 pubkeys in the clear;
2. ECDH → shared secret; transcript = SHA-256 over a domain tag and
   both ephemeral keys in sorted order (the reference uses a Merlin
   transcript; HKDF-SHA256 with the transcript as salt gives the same
   binding without a STROBE dependency);
3. HKDF → two ChaCha20-Poly1305 keys (sorted-low side sends with the
   first) + a challenge;
4. each side sends, encrypted, its node pubkey and an ed25519
   signature over the challenge — authenticating the connection to the
   node identity (reference :392 signChallenge).

Framing: every record is AEAD-sealed over a fixed 1024-byte frame
(2-byte big-endian payload length + payload + zero padding), nonce =
96-bit little-endian send counter, ciphertext preceded by nothing —
frames are fixed-size so record boundaries leak no payload sizes
(reference: dataMaxSize 1024).
"""

from __future__ import annotations

import asyncio
import hashlib

from ...crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey

# `cryptography` is imported lazily (first connection, not module
# import) so the whole p2p/consensus reactor stack stays importable in
# environments without it. Real TCP connections still require the
# package. This is host crypto: no kernel runs here.


def _aead(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    return ChaCha20Poly1305(key)

FRAME_SIZE = 1024
DATA_MAX = FRAME_SIZE - 2
SEALED_SIZE = FRAME_SIZE + 16  # poly1305 tag

_DOMAIN = b"TENDERMINT_TPU_SECRET_CONNECTION_V1"


class AuthError(Exception):
    pass


def _hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    from cryptography.hazmat.primitives.hashes import SHA256
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    return HKDF(algorithm=SHA256(), length=length, salt=salt,
                info=info).derive(ikm)


class SecretConnection:
    """AEAD-framed duplex stream bound to the remote's node pubkey."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 send_key: bytes, recv_key: bytes,
                 remote_pubkey: Ed25519PubKey | None = None):
        self._reader = reader
        self._writer = writer
        self._send_aead = _aead(send_key)
        self._recv_aead = _aead(recv_key)
        self._send_nonce = 0
        self._recv_nonce = 0
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""

    # -- raw frame layer --

    def _next_nonce(self, n: int) -> bytes:
        return n.to_bytes(12, "little")

    def write_frame(self, payload: bytes) -> None:
        assert len(payload) <= DATA_MAX
        frame = len(payload).to_bytes(2, "big") + payload
        frame += b"\x00" * (FRAME_SIZE - len(frame))
        sealed = self._send_aead.encrypt(
            self._next_nonce(self._send_nonce), frame, None)
        self._send_nonce += 1
        self._writer.write(sealed)

    async def drain(self) -> None:
        await self._writer.drain()

    async def read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_SIZE)
        frame = self._recv_aead.decrypt(
            self._next_nonce(self._recv_nonce), sealed, None)
        self._recv_nonce += 1
        ln = int.from_bytes(frame[:2], "big")
        if ln > DATA_MAX:
            raise AuthError("corrupt frame length")
        return frame[2:2 + ln]

    # -- message layer (length-prefixed, spanning frames) --

    async def write_msg(self, data: bytes) -> None:
        buf = len(data).to_bytes(4, "big") + data
        for i in range(0, len(buf), DATA_MAX):
            self.write_frame(buf[i:i + DATA_MAX])
        await self.drain()

    # write_msg/read_msg carry only handshake records (auth, NodeInfo);
    # bulk traffic rides MConnection packets. Cap the claimed length so
    # a pre-NodeInfo peer can't make us buffer gigabytes.
    MAX_MSG = 1 << 20

    async def read_msg(self) -> bytes:
        while len(self._recv_buf) < 4:
            self._recv_buf += await self.read_frame()
        ln = int.from_bytes(self._recv_buf[:4], "big")
        if ln > self.MAX_MSG:
            raise AuthError(f"msg length {ln} exceeds cap")
        while len(self._recv_buf) < 4 + ln:
            self._recv_buf += await self.read_frame()
        msg = self._recv_buf[4:4 + ln]
        self._recv_buf = self._recv_buf[4 + ln:]
        return msg

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


async def make_secret_connection(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
    priv_key: Ed25519PrivKey,
) -> SecretConnection:
    """Run the STS handshake; returns an authenticated connection.
    reference: MakeSecretConnection (secret_connection.go:92)."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey,
    )

    eph_priv = X25519PrivateKey.generate()
    eph_pub = eph_priv.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    # 1. swap ephemerals in the clear
    writer.write(eph_pub)
    await writer.drain()
    their_eph = await reader.readexactly(32)

    # 2. shared secret + transcript
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(their_eph))
    lo, hi = sorted((eph_pub, their_eph))
    transcript = hashlib.sha256(_DOMAIN + lo + hi).digest()

    # 3. derive keys; sorted-low side sends with key1
    okm = _hkdf_sha256(shared, transcript, b"secret-connection-keys", 96)
    key1, key2, challenge = okm[:32], okm[32:64], okm[64:]
    if eph_pub == lo:
        send_key, recv_key = key1, key2
    else:
        send_key, recv_key = key2, key1

    sc = SecretConnection(reader, writer, send_key, recv_key)

    # 4. authenticate: swap (node pubkey, sig(challenge)) under the AEAD
    sig = priv_key.sign(challenge)
    await sc.write_msg(priv_key.pub_key().bytes() + sig)
    auth = await sc.read_msg()
    if len(auth) != 32 + 64:
        raise AuthError("bad auth message size")
    remote_pub = Ed25519PubKey(auth[:32])
    if not remote_pub.verify_signature(challenge, auth[32:]):
        raise AuthError("challenge signature verification failed")
    sc.remote_pubkey = remote_pub
    return sc
