"""Bit arrays for part and vote bookkeeping (reference:
libs/bits/bit_array.go)."""

from __future__ import annotations

import random
import secrets

# pick_random's draw: the OS's entropy, as the reference's; the
# simulator seeds it (seed_picks) so that a (scenario, seed) pair
# replays its gossip order.
_randbelow = secrets.randbelow


def seed_picks(seed: int | None) -> None:
    """Draw pick_random from random.Random(seed) from now on; None
    restores the OS's entropy."""
    global _randbelow
    _randbelow = (secrets.randbelow if seed is None
                  else random.Random(seed).randrange)


class BitArray:
    __slots__ = ("size", "_bits")

    def __init__(self, size: int):
        if size < 0:
            raise ValueError("negative size")
        self.size = size
        self._bits = 0

    def get(self, i: int) -> bool:
        if not 0 <= i < self.size:
            return False
        return bool((self._bits >> i) & 1)

    def set(self, i: int, v: bool) -> bool:
        if not 0 <= i < self.size:
            return False
        if v:
            self._bits |= 1 << i
        else:
            self._bits &= ~(1 << i)
        return True

    def is_empty(self) -> bool:
        return self._bits == 0

    def is_full(self) -> bool:
        return self.size > 0 and self._bits == (1 << self.size) - 1

    def count(self) -> int:
        return bin(self._bits).count("1")

    def copy(self) -> "BitArray":
        b = BitArray(self.size)
        b._bits = self._bits
        return b

    def or_(self, other: "BitArray") -> "BitArray":
        b = BitArray(max(self.size, other.size))
        b._bits = self._bits | other._bits
        return b

    def and_(self, other: "BitArray") -> "BitArray":
        b = BitArray(min(self.size, other.size))
        b._bits = self._bits & other._bits & ((1 << b.size) - 1)
        return b

    def not_(self) -> "BitArray":
        b = BitArray(self.size)
        b._bits = ~self._bits & ((1 << self.size) - 1)
        return b

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other."""
        b = BitArray(self.size)
        mask = other._bits & ((1 << self.size) - 1)
        b._bits = self._bits & ~mask
        return b

    def pick_random(self) -> tuple[int, bool]:
        """A uniformly random set bit's index (for gossip selection)."""
        idxs = [i for i in range(self.size) if self.get(i)]
        if not idxs:
            return 0, False
        return idxs[_randbelow(len(idxs))], True

    def to_bytes(self) -> bytes:
        nbytes = (self.size + 7) // 8
        return self._bits.to_bytes(nbytes, "little")

    @classmethod
    def from_bytes(cls, size: int, data: bytes) -> "BitArray":
        b = cls(size)
        b._bits = int.from_bytes(data, "little") & ((1 << size) - 1) if size else 0
        return b

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.size == other.size
            and self._bits == other._bits
        )

    def __repr__(self) -> str:
        return "BitArray{%s}" % "".join("x" if self.get(i) else "_" for i in range(self.size))
