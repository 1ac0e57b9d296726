"""Merlin transcripts (STROBE-128 over Keccak-f[1600]).

Host-side oracle for sr25519/schnorrkel signature verification
(reference: crypto/sr25519/pubkey.go:34-61 via ChainSafe/go-schnorrkel,
which mirrors the Rust `merlin` crate); a copy of the JAX package's
crypto/merlin.py. The transcript is sequential and byte-oriented, so
it stays on the host; only the group equation runs on the GPU.

Implements exactly the subset merlin uses:
  - Strobe128: meta-AD, AD, PRF, KEY (no transport ops)
  - Transcript: append_message, challenge_bytes

The merlin crate's known vector is pinned in tests/test_torch_sr25519.py.
"""

from __future__ import annotations

# --- Keccak-f[1600] ---

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Permutation over 25 uint64 lanes, flat index a[x + 5y]."""
    a = list(lanes)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi: b[y, 2x+3y] = rotl(a[x, y], r[x][y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    a[x + 5 * y], _ROTC[x][y]
                )
        # chi: a[x, y] = b[x, y] ^ (~b[x+1, y] & b[x+2, y])
        a = [
            b[x + 5 * y] ^ ((b[(x + 1) % 5 + 5 * y] ^ _M64)
                            & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


class Strobe128:
    """The merlin-flavored STROBE-128/1600 (no transport)."""

    R = 166  # rate in bytes for 128-bit security over keccak-f1600

    FLAG_I = 1
    FLAG_A = 2
    FLAG_C = 4
    FLAG_T = 8
    FLAG_M = 16
    FLAG_K = 32

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, self.R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = self._permute(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @staticmethod
    def _permute(st: bytearray) -> bytearray:
        lanes = [
            int.from_bytes(st[8 * i: 8 * i + 8], "little") for i in range(25)
        ]
        lanes = keccak_f1600(lanes)
        out = bytearray(200)
        for i, lane in enumerate(lanes):
            out[8 * i: 8 * i + 8] = lane.to_bytes(8, "little")
        return out

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[self.R + 1] ^= 0x80
        self.state = self._permute(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == self.R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == self.R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continued op")
            return
        if flags & self.FLAG_T:
            raise ValueError("transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (self.FLAG_C | self.FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(self.FLAG_M | self.FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(self.FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(self.FLAG_I | self.FLAG_A | self.FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(self.FLAG_A | self.FLAG_C, more)
        # overwrite (KEY uses duplex overwrite semantics)
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == self.R:
                self._run_f()


class Transcript:
    """Merlin transcript (merlin v1.0 domain separation)."""

    def __init__(self, label: bytes):
        self._strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        import copy

        t = object.__new__(Transcript)
        t._strobe = copy.deepcopy(self._strobe)
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self._strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self._strobe.prf(n, False)
