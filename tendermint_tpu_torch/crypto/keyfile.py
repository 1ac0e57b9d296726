"""Armored, passphrase-encrypted private-key files (reference:
tendermint_tpu/crypto/keyfile.py, copied; a file either package writes
the other reads).

Go parity surface: the Go reference's crypto/armor + xsalsa20
secretbox combination used for exported/encrypted keys (its keyring
uses bcrypt as the KDF; this build uses scrypt — bcrypt isn't in the
image — with the KDF recorded in the armor headers so files are
self-describing)."""

from __future__ import annotations

import os

from .armor import decode_armor, encode_armor
from .symmetric import decrypt_symmetric, encrypt_symmetric

_BLOCK_TYPE = "TENDERMINT PRIVATE KEY"


def _kdf(passphrase: str, salt: bytes) -> bytes:
    from cryptography.hazmat.primitives.kdf.scrypt import Scrypt

    return Scrypt(salt=salt, length=32, n=1 << 14, r=8, p=1).derive(
        passphrase.encode())


def encrypt_armor_priv_key(priv_bytes: bytes, passphrase: str,
                           key_type: str = "ed25519") -> str:
    salt = os.urandom(16)
    box = encrypt_symmetric(priv_bytes, _kdf(passphrase, salt))
    return encode_armor(_BLOCK_TYPE, {
        "kdf": "scrypt",
        "salt": salt.hex().upper(),
        "type": key_type,
    }, box)


def unarmor_decrypt_priv_key(armor_str: str,
                             passphrase: str) -> tuple[bytes, str]:
    """-> (priv key bytes, key type); ValueError on bad pass/corruption."""
    block_type, headers, box = decode_armor(armor_str)
    if block_type != _BLOCK_TYPE:
        raise ValueError(f"unrecognized armor type {block_type!r}")
    if headers.get("kdf") != "scrypt":
        raise ValueError(f"unsupported kdf {headers.get('kdf')!r}")
    salt = bytes.fromhex(headers.get("salt", ""))
    if len(salt) != 16:
        raise ValueError("missing or malformed salt header")
    priv = decrypt_symmetric(box, _kdf(passphrase, salt))
    return priv, headers.get("type", "")
