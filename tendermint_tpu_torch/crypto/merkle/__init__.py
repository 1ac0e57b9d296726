"""RFC-6962-style merkle root with domain-separated leaf/inner hashing
(reference: crypto/merkle/tree.go:9,62) — only the root that
validator-set and commit hashes use."""

from __future__ import annotations

import hashlib

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def empty_hash() -> bytes:
    return _sha(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    b = 1 << (n - 1).bit_length() - 1
    if b == n:
        b >>= 1
    return b


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))
