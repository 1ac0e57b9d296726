"""RFC-6962-style merkle tree with domain-separated leaf/inner hashing
(reference: crypto/merkle/tree.go:9,62 for the root that validator-set,
commit and header hashes use; crypto/merkle/proof.go:35,52 for the
proofs a block's part set carries; proof_op.go for the composable
proof operators an app's query proofs are checked with)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

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


@dataclass
class Proof:
    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def compute_root(self) -> bytes | None:
        if self.index >= self.total or self.index < 0 or self.total <= 0:
            return None
        return _root_from_aunts(self.index, self.total, self.leaf_hash,
                                self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        return self.compute_root() == root


def _root_from_aunts(index: int, total: int, lh: bytes,
                     aunts: list[bytes]) -> bytes | None:
    if total == 0:
        return None
    if total == 1:
        if aunts:
            return None
        return lh
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _root_from_aunts(index, k, lh, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _root_from_aunts(index - k, total - k, lh, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    trails, root_node = _trails_from_byte_slices(items)
    root = root_node.hash if root_node else empty_hash()
    proofs = [
        Proof(total=len(items), index=i, leaf_hash=t.hash,
              aunts=t.flatten_aunts())
        for i, t in enumerate(trails)
    ]
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None  # sibling on the left
        self.right = None  # sibling on the right

    def flatten_aunts(self) -> list[bytes]:
        aunts = []
        node = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            elif node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(items: list[bytes]):
    n = len(items)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(leaf_hash(items[0]))
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root


# --- Proof operator composition (reference: crypto/merkle/proof_op.go) -------


class ProofOp:
    """One step of a composable proof: key + typed verification."""

    def __init__(self, op_type: str, key: bytes, data: bytes):
        self.op_type = op_type
        self.key = key
        self.data = data


class ProofOperator:
    """Structural interface for one composable proof step."""

    def run(self, values: list[bytes]) -> list[bytes]:  # pragma: no cover
        raise NotImplementedError

    def get_key(self) -> bytes:  # pragma: no cover
        raise NotImplementedError


class ProofOperators(list):
    def verify_value(self, root: bytes, keypath: list[bytes], value: bytes) -> bool:
        return self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: list[bytes], args: list[bytes]) -> bool:
        keys = list(keypath)
        for op in self:
            key = op.get_key()
            if key:
                if not keys or keys[-1] != key:
                    return False
                keys.pop()
            try:
                args = op.run(args)
            except Exception:
                return False
        return bool(args) and args[0] == root and not keys


class ProofRuntime:
    """Registry of ProofOp decoders (reference:
    crypto/merkle/proof_op.go ProofRuntime): apps emit wire-level
    `ProofOp(type, key, data)` triples; verifiers decode each through
    the decoder registered for its type and run the resulting
    operator chain. Keypaths here are `list[bytes]` (innermost key
    LAST, matching ProofOperators.verify) rather than the reference's
    URL-escaped KeyPath strings."""

    def __init__(self):
        self._decoders: dict[str, object] = {}

    def register(self, op_type: str, decoder) -> None:
        self._decoders[op_type] = decoder

    def decode(self, op: ProofOp) -> ProofOperator:
        dec = self._decoders.get(op.op_type)
        if dec is None:
            raise ValueError(f"unregistered proof op type {op.op_type!r}")
        return dec(op)

    def _operators(self, ops: list[ProofOp]) -> ProofOperators:
        return ProofOperators(self.decode(op) for op in ops)

    def verify_value(self, ops: list[ProofOp], root: bytes,
                     keypath: list[bytes], value: bytes) -> bool:
        try:
            return self._operators(ops).verify_value(root, keypath, value)
        except ValueError:
            return False

    def verify_absence(self, ops: list[ProofOp], root: bytes,
                       keypath: list[bytes]) -> bool:
        try:
            return self._operators(ops).verify(root, keypath, [])
        except ValueError:
            return False
