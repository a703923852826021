"""Minimal protobuf wire-format codec (no protoc dependency).

The port's copy of ``smallhardface_tpu/io/protowire.py``: it reads
``.caffemodel`` files (a binary NetParameter of the reference Caffe fork's
``caffe.proto``) without vendoring Caffe, and writes them
(``io/caffemodel.py``). Only the wire-level primitives live here; the
Caffe schema subset is interpreted in ``io/caffemodel.py``.
"""

from __future__ import annotations

import struct

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_LEN = 2
WIRE_32BIT = 5


def read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(data):
    """Yield (field_number, wire_type, value) over a serialized message.

    value is: int for varint, bytes for length-delimited, raw 4/8-byte
    chunk (bytes) for fixed32/fixed64.
    """
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wt == WIRE_LEN:
            length, pos = read_varint(buf, pos)
            if pos + length > end:
                raise ValueError(
                    f"truncated message: field {field} wants {length} bytes, "
                    f"{end - pos} left")
            val = bytes(buf[pos:pos + length])
            pos += length
        elif wt == WIRE_32BIT:
            if pos + 4 > end:
                raise ValueError(f"truncated fixed32 in field {field}")
            val = bytes(buf[pos:pos + 4])
            pos += 4
        elif wt == WIRE_64BIT:
            if pos + 8 > end:
                raise ValueError(f"truncated fixed64 in field {field}")
            val = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def parse_packed_floats(raw: bytes):
    return struct.unpack(f"<{len(raw) // 4}f", raw)


def parse_packed_varints(raw: bytes):
    buf = memoryview(raw)
    pos = 0
    out = []
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def tag(field: int, wire_type: int) -> bytes:
    return write_varint((field << 3) | wire_type)


def emit_len(field: int, payload: bytes) -> bytes:
    return tag(field, WIRE_LEN) + write_varint(len(payload)) + payload


def emit_string(field: int, s: str) -> bytes:
    return emit_len(field, s.encode("utf-8"))


def emit_varint_field(field: int, value: int) -> bytes:
    return tag(field, WIRE_VARINT) + write_varint(value)


def emit_packed_floats(field: int, values) -> bytes:
    payload = struct.pack(f"<{len(values)}f", *values)
    return emit_len(field, payload)
