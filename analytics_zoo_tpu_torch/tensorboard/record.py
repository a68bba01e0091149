"""TFRecord framing + CRC32C + minimal Event/Summary protobuf encoding.

The port's own copy of ``analytics_zoo_tpu/tensorboard/record.py`` (which
imports no JAX): the handful of proto fields TensorBoard reads, encoded by
hand, so summaries need no tensorflow, with the reference's bytes
(``encode_event``, the masked CRC32C framing).  The CRC comes from the
port's native host library (``analytics_zoo_tpu_torch.native``) when it is
built, as in the reference; the pure-Python table is always there.
"""

from __future__ import annotations

import struct
import time

from analytics_zoo_tpu_torch import native as _native

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    # ``lib`` is read per call, so a library built later is used
    if _native.lib is not None:
        return _native.lib.crc32c(data)
    return _crc32c_py(data)


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing (RecordWriter.scala role)
# ---------------------------------------------------------------------------


def write_record(fh, data: bytes) -> None:
    header = struct.pack("<Q", len(data))
    fh.write(header)
    fh.write(struct.pack("<I", masked_crc(header)))
    fh.write(data)
    fh.write(struct.pack("<I", masked_crc(data)))


def read_records(fh):
    while True:
        header = fh.read(8)
        if len(header) < 8:
            return
        (length,) = struct.unpack("<Q", header)
        fh.read(4)  # header crc
        data = fh.read(length)
        fh.read(4)  # data crc
        yield data


# ---------------------------------------------------------------------------
# Protobuf encoding (Summary.scala role) — only what TB reads
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def encode_scalar_summary(tag: str, value: float) -> bytes:
    """Summary{ value: [Value{ tag=1, simple_value=2 }] }"""
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


def encode_event(step: int = 0, wall_time: float | None = None,
                 summary: bytes | None = None,
                 file_version: str | None = None) -> bytes:
    """Event{ wall_time=1, step=2, file_version=3, summary=5 }"""
    out = _field_double(1, wall_time if wall_time is not None else
                        time.time())
    if step:
        out += _field_varint(2, int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


# -- decoding (for scalar read-back, FileWriter read API role) --------------


def _iter_fields(data: bytes):
    i = 0
    n = len(data)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        num, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield num, wire, val
        elif wire == 1:
            yield num, wire, data[i:i + 8]
            i += 8
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield num, wire, data[i:i + ln]
            i += ln
        elif wire == 5:
            yield num, wire, data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def decode_event_scalars(data: bytes):
    """Yield (wall_time, step, tag, value) scalars from one Event proto."""
    wall_time, step, summary = 0.0, 0, None
    for num, wire, val in _iter_fields(data):
        if num == 1 and wire == 1:
            (wall_time,) = struct.unpack("<d", val)
        elif num == 2 and wire == 0:
            step = val
        elif num == 5 and wire == 2:
            summary = val
    if summary is None:
        return
    for num, wire, val in _iter_fields(summary):
        if num == 1 and wire == 2:  # Summary.Value
            tag, simple = None, None
            for n2, w2, v2 in _iter_fields(val):
                if n2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif n2 == 2 and w2 == 5:
                    (simple,) = struct.unpack("<f", v2)
            if tag is not None and simple is not None:
                yield wall_time, step, tag, simple
