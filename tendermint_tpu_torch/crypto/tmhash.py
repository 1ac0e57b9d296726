"""SHA-256 hashing helpers (reference: crypto/tmhash)."""

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def sum_truncated(b: bytes) -> bytes:
    """First 20 bytes of SHA-256 — used for addresses."""
    return hashlib.sha256(b).digest()[:TRUNCATED_SIZE]
