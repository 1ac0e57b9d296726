"""Merkle proof format for the proof-capable kvstore app (reference:
abci/kv_proofs.py).

The reference's light RPC client verifies every abci_query response
against the light-verified app hash via a ProofRuntime
(light/rpc/client.go:104-151); the proof FORMAT itself is app-defined
(cosmos uses iavl ops). This module defines the format for this
repo's MerkleKVStoreApp (abci/kvstore.py): the app hash is an
RFC-6962 merkle root over the store's kv pairs sorted by key, and a
query response carries either

  kv:v  — a value (existence) proof: the merkle branch for the
          (key, value) leaf; the value rides the args chain so a
          tampered value changes the recomputed root.
  kv:a  — an absence proof: the merkle branches of the key's sorted
          NEIGHBORS. Adjacent indices whose keys straddle the queried
          key prove no leaf between them; boundary cases prove the
          first/last leaf instead. Sound because honest nodes build
          the tree over sorted unique keys — any pair of adjacent
          leaves proving into the trusted root leaves no room for the
          queried key.

Wire shape: ProofOp.data is JSON (matching the repo's ABCI codec);
ops decode through the registry from kv_proof_runtime().
"""

from __future__ import annotations

import json
import struct

from ..crypto import merkle


def kv_leaf(key: bytes, value: bytes) -> bytes:
    """Injective (key, value) leaf encoding: 4-byte BE length prefixes."""
    return struct.pack(">I", len(key)) + key + \
        struct.pack(">I", len(value)) + value


def _branch_json(p: merkle.Proof) -> dict:
    return {"index": p.index, "aunts": [a.hex() for a in p.aunts]}


def _branch_root(total: int, index: int, leaf: bytes,
                 aunts_hex: list) -> bytes | None:
    p = merkle.Proof(total=total, index=int(index),
                     leaf_hash=merkle.leaf_hash(leaf),
                     aunts=[bytes.fromhex(a) for a in aunts_hex])
    return p.compute_root()


class KVValueOp(merkle.ProofOperator):
    """Existence: recompute the root from (key, args[0]) at the proved
    position. data = {"total", "index", "aunts"}."""

    OP_TYPE = "kv:v"

    def __init__(self, key: bytes, d: dict):
        self.key = key
        self.d = d

    def get_key(self) -> bytes:
        return self.key

    def run(self, args: list[bytes]) -> list[bytes]:
        if len(args) != 1:
            raise ValueError("kv:v expects exactly the value")
        root = _branch_root(int(self.d["total"]), self.d["index"],
                            kv_leaf(self.key, args[0]), self.d["aunts"])
        if root is None:
            raise ValueError("invalid value proof shape")
        return [root]

    @classmethod
    def encode(cls, key: bytes, total: int, proof: merkle.Proof) -> dict:
        return {"type": cls.OP_TYPE, "key": key,
                "data": json.dumps({"total": total,
                                    **_branch_json(proof)}).encode()}


class KVAbsenceOp(merkle.ProofOperator):
    """Absence: the sorted neighbors of the (missing) key prove into
    the root with adjacent indices. data = {"total", "left"?,
    "right"?} where each side is {"key", "value", "index", "aunts"}
    (hex keys/values)."""

    OP_TYPE = "kv:a"

    def __init__(self, key: bytes, d: dict):
        self.key = key
        self.d = d

    def get_key(self) -> bytes:
        return self.key

    def run(self, args: list[bytes]) -> list[bytes]:
        if args:
            raise ValueError("kv:a takes no value")
        total = int(self.d["total"])
        left, right = self.d.get("left"), self.d.get("right")
        if total == 0:
            if left or right:
                raise ValueError("empty tree takes no neighbors")
            return [merkle.empty_hash()]

        def side_root(s) -> tuple[bytes, bytes, int]:
            k = bytes.fromhex(s["key"])
            root = _branch_root(total, s["index"],
                                kv_leaf(k, bytes.fromhex(s["value"])),
                                s["aunts"])
            if root is None:
                raise ValueError("invalid neighbor proof shape")
            return root, k, int(s["index"])

        if left and right:
            root_l, k_l, i_l = side_root(left)
            root_r, k_r, i_r = side_root(right)
            if not (k_l < self.key < k_r):
                raise ValueError("neighbors do not straddle the key")
            if i_r != i_l + 1 or root_l != root_r:
                raise ValueError("neighbors not adjacent in one tree")
            return [root_l]
        if left:
            root_l, k_l, i_l = side_root(left)
            if not (k_l < self.key and i_l == total - 1):
                raise ValueError("left neighbor must be the last leaf")
            return [root_l]
        if right:
            root_r, k_r, i_r = side_root(right)
            if not (self.key < k_r and i_r == 0):
                raise ValueError("right neighbor must be the first leaf")
            return [root_r]
        raise ValueError("non-empty tree needs at least one neighbor")

    @classmethod
    def encode(cls, key: bytes, total: int,
               left: tuple[bytes, bytes, merkle.Proof] | None,
               right: tuple[bytes, bytes, merkle.Proof] | None) -> dict:
        def side(t):
            if t is None:
                return None
            k, v, p = t
            return {"key": k.hex(), "value": v.hex(), **_branch_json(p)}

        return {"type": cls.OP_TYPE, "key": key,
                "data": json.dumps({"total": total, "left": side(left),
                                    "right": side(right)}).encode()}


def _decode(cls):
    def dec(op: merkle.ProofOp):
        return cls(op.key, json.loads(op.data))
    return dec


def kv_proof_runtime() -> merkle.ProofRuntime:
    """Default runtime knowing the kvstore proof formats (reference:
    merkle.DefaultProofRuntime with ValueOp registered)."""
    rt = merkle.ProofRuntime()
    rt.register(KVValueOp.OP_TYPE, _decode(KVValueOp))
    rt.register(KVAbsenceOp.OP_TYPE, _decode(KVAbsenceOp))
    return rt
