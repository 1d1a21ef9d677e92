# Frozen copy of graphaligner_tpu_torch/io/wire.py, part of the benchmark's plain reference (imports nothing of the program).
"""Protobuf wire-format primitives.

A minimal, dependency-free codec for the protobuf wire format, sufficient
for the vg ecosystem schema (see vg.py). Encoding follows proto3 rules:
fields are emitted in field-number order and default values are skipped,
matching the byte output of the protobuf C++ runtime the reference links
against (reference: vg.pb.cpp serialization, stream.hpp framing).
"""

from __future__ import annotations

import struct

# Wire types
VARINT = 0
FIXED64 = 1
LENGTH_DELIMITED = 2
FIXED32 = 5


def encode_varint(value: int) -> bytes:
    """Encode a non-negative integer as a base-128 varint."""
    if value < 0:
        # Negative int32/int64 values are sign-extended to 64 bits.
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def decode_signed_varint(data: bytes, pos: int) -> tuple[int, int]:
    """Decode a varint, interpreting it as a signed 64-bit two's-complement."""
    value, pos = decode_varint(data, pos)
    if value >= 1 << 63:
        value -= 1 << 64
    return value, pos


def encode_zigzag(value: int) -> bytes:
    """sint32/sint64 zigzag encoding."""
    return encode_varint((value << 1) ^ (value >> 63))


def decode_zigzag(data: bytes, pos: int) -> tuple[int, int]:
    value, pos = decode_varint(data, pos)
    return (value >> 1) ^ -(value & 1), pos


def encode_tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def encode_double(value: float) -> bytes:
    return struct.pack("<d", value)


def decode_double(data: bytes, pos: int) -> tuple[float, int]:
    return struct.unpack_from("<d", data, pos)[0], pos + 8


def skip_field(data: bytes, pos: int, wire_type: int) -> int:
    """Skip over an unknown field's payload; returns new position."""
    if wire_type == VARINT:
        _, pos = decode_varint(data, pos)
        return pos
    if wire_type == FIXED64:
        return pos + 8
    if wire_type == LENGTH_DELIMITED:
        size, pos = decode_varint(data, pos)
        return pos + size
    if wire_type == FIXED32:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")
