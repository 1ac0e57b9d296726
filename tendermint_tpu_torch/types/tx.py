"""Transactions (reference: types/tx.py; Go types/tx.go)."""

from __future__ import annotations

from ..crypto import merkle, tmhash

Tx = bytes


def tx_hash(tx: Tx) -> bytes:
    return tmhash.sum256(tx)


def txs_hash(txs: list[Tx]) -> bytes:
    """Merkle root over raw txs (reference: types/tx.go Txs.Hash)."""
    return merkle.hash_from_byte_slices(list(txs))


def tx_proof(txs: list[Tx], i: int):
    root, proofs = merkle.proofs_from_byte_slices(list(txs))
    return root, proofs[i]
