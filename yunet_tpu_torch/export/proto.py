"""Minimal protobuf wire-format codec (no protoc / onnx dependency).

Implements just enough of proto3 encoding to read and write ONNX model
files: varints, length-delimited fields, 32/64-bit scalars, packed
repeated fields. Messages are represented as dicts
{field_number: [values]} where a value is int (varint), bytes
(length-delimited) or a (wire_type, raw) tuple for fixed-width fields.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

Value = Union[int, bytes, Tuple[int, bytes]]
Message = Dict[int, List[Value]]


def encode_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def decode_message(buf: bytes) -> Message:
    msg: Message = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = decode_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:  # varint
            v, pos = decode_varint(buf, pos)
            msg.setdefault(field, []).append(v)
        elif wire == 1:  # 64-bit
            msg.setdefault(field, []).append((1, buf[pos:pos + 8]))
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = decode_varint(buf, pos)
            msg.setdefault(field, []).append(buf[pos:pos + ln])
            pos += ln
        elif wire == 5:  # 32-bit
            msg.setdefault(field, []).append((5, buf[pos:pos + 4]))
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
    return msg


def encode_message(msg: Message) -> bytes:
    out = bytearray()
    for field in sorted(msg):
        for v in msg[field]:
            if isinstance(v, int):
                out += encode_varint((field << 3) | 0)
                out += encode_varint(v)
            elif isinstance(v, bytes):
                out += encode_varint((field << 3) | 2)
                out += encode_varint(len(v))
                out += v
            elif isinstance(v, tuple):
                wire, raw = v
                out += encode_varint((field << 3) | wire)
                out += raw
            else:
                raise TypeError(f"bad value {type(v)} in field {field}")
    return bytes(out)


# helpers -------------------------------------------------------------------

def sub(msg: Message, field: int) -> List[Message]:
    return [decode_message(b) for b in msg.get(field, [])]

def sub1(msg: Message, field: int) -> Message:
    vals = msg.get(field, [])
    return decode_message(vals[0]) if vals else {}

def get_str(msg: Message, field: int, default: str = "") -> str:
    vals = msg.get(field, [])
    return vals[0].decode() if vals else default

def get_strs(msg: Message, field: int) -> List[str]:
    return [b.decode() for b in msg.get(field, [])]

def get_int(msg: Message, field: int, default: int = 0) -> int:
    vals = msg.get(field, [])
    return vals[0] if vals else default

def get_ints(msg: Message, field: int) -> List[int]:
    return list(msg.get(field, []))

def get_bytes(msg: Message, field: int) -> bytes:
    vals = msg.get(field, [])
    return vals[0] if vals else b""

def f32(value: float) -> Tuple[int, bytes]:
    return (5, struct.pack("<f", value))
