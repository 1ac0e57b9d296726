"""Deterministic protobuf wire encoding (copy of the reference's)."""

from .proto import Writer, encode_varint

__all__ = ["Writer", "encode_varint"]
