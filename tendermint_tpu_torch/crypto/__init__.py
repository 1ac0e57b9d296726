"""Crypto layer: key interfaces, registry, and batch verification.

Mirrors the reference's capability surface (crypto/crypto.go:23-43): a
``PubKey``/``PrivKey`` pair per scheme, address = first 20 bytes of
SHA-256(pubkey). Batches of (pk, msg, sig) triples go through
``crypto.batch.BatchVerifier``, which runs wide ones on the GPU.
The port registers ed25519 and sr25519 (no secp256k1 yet).
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class PubKey(ABC):
    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @property
    @abstractmethod
    def type_name(self) -> str: ...

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PubKey)
            and self.type_name == other.type_name
            and self.bytes() == other.bytes()
        )

    def __hash__(self) -> int:
        return hash((self.type_name, self.bytes()))


class PrivKey(ABC):
    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...

    @property
    @abstractmethod
    def type_name(self) -> str: ...


# type_name -> (pubkey constructor from bytes)
_PUBKEY_REGISTRY: dict[str, type] = {}


def register_pubkey(type_name: str, cls: type) -> None:
    _PUBKEY_REGISTRY[type_name] = cls


def pubkey_from_type_and_bytes(type_name: str, data: bytes) -> PubKey:
    if type_name not in _PUBKEY_REGISTRY:
        _ensure_registered()
    try:
        cls = _PUBKEY_REGISTRY[type_name]
    except KeyError:
        raise ValueError(f"unknown pubkey type {type_name!r}") from None
    return cls(data)


def _ensure_registered() -> None:
    """Import every key-type module of the port so its register_pubkey
    ran (the reference's set also has secp256k1, not ported yet)."""
    from . import ed25519, sr25519  # noqa: F401
