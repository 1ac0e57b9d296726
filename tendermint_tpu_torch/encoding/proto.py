"""Minimal protobuf wire-format primitives.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
Only what the framework needs; deterministic by construction (fields
are written in the order the caller writes them — canonical encoders
write in ascending field order and skip zero values, matching proto3
canonical form).
"""

from __future__ import annotations

import struct


def encode_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement, like protobuf int64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int = 0) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")
    if result >= 1 << 64:
        raise ValueError("varint exceeds 64 bits")
    if result >= 1 << 63:
        result -= 1 << 64
    return result, pos


def encode_zigzag(v: int) -> bytes:
    return encode_varint((v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)


class Writer:
    """Append-only protobuf wire writer."""

    def __init__(self):
        self._buf = bytearray()

    def _tag(self, field: int, wire_type: int) -> None:
        self._buf += encode_varint((field << 3) | wire_type)

    def varint(self, field: int, v: int, *, skip_zero: bool = True) -> "Writer":
        if v == 0 and skip_zero:
            return self
        self._tag(field, 0)
        self._buf += encode_varint(v)
        return self

    def bool(self, field: int, v: bool) -> "Writer":
        return self.varint(field, 1 if v else 0)

    def sfixed64(self, field: int, v: int, *, skip_zero: bool = True) -> "Writer":
        if v == 0 and skip_zero:
            return self
        self._tag(field, 1)
        self._buf += struct.pack("<q", v)
        return self

    def bytes(self, field: int, v: bytes, *, skip_empty: bool = True) -> "Writer":
        if not v and skip_empty:
            return self
        self._tag(field, 2)
        self._buf += encode_varint(len(v))
        self._buf += v
        return self

    def string(self, field: int, v: str, *, skip_empty: bool = True) -> "Writer":
        return self.bytes(field, v.encode(), skip_empty=skip_empty)

    def message(self, field: int, sub: "Writer | bytes | None") -> "Writer":
        if sub is None:
            return self
        payload = sub.finish() if isinstance(sub, Writer) else sub
        self._tag(field, 2)
        self._buf += encode_varint(len(payload))
        self._buf += payload
        return self

    def finish(self) -> bytes:
        return bytes(self._buf)


class Reader:
    """Streaming protobuf wire reader."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def at_end(self) -> bool:
        return self._pos >= len(self._data)

    def field(self) -> tuple[int, int]:
        tag, self._pos = decode_varint(self._data, self._pos)
        return tag >> 3, tag & 7

    def varint(self) -> int:
        v, self._pos = decode_varint(self._data, self._pos)
        return v

    def sfixed64(self) -> int:
        v = struct.unpack_from("<q", self._data, self._pos)[0]
        self._pos += 8
        return v

    def bytes(self) -> bytes:
        ln, self._pos = decode_varint(self._data, self._pos)
        if ln < 0 or self._pos + ln > len(self._data):
            raise ValueError("truncated bytes field")
        out = self._data[self._pos : self._pos + ln]
        self._pos += ln
        return out

    def string(self) -> str:
        return self.bytes().decode()

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self._pos += 8
        elif wire_type == 2:
            self.bytes()
        elif wire_type == 5:
            self._pos += 4
        else:
            raise ValueError(f"unknown wire type {wire_type}")
