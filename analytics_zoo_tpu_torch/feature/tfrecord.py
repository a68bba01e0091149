"""TFRecord file reading + tf.train.Example codec — no tensorflow needed.

The port's own copy of ``analytics_zoo_tpu/feature/tfrecord.py`` (which
imports no JAX), byte for byte the same reader.  Reference:
``TFDataset.from_tfrecord_file`` (pyzoo
zoo/pipeline/api/net/tf_dataset.py:456-501) and the byte/feature dataset
variants (:629-713).  The TFRecord framing + CRC32C of the port's
TensorBoard writer (``tensorboard/record.py``, the RecordWriter.scala role;
its CRC on the native host library when that is built) is reused for
READING, and a hand protobuf codec decodes tf.train.Example, so ImageNet
TFRecord shards feed training with no tensorflow.  JPEG records need cv2
(``imagenet_example_parser``); a parse function that reads raw pixels
needs nothing else.

Wire format (tensorflow/core/example/example.proto):
  Example  { features: Features = 1 }
  Features { feature: map<string, Feature> = 1 }
  Feature  { bytes_list = 1 | float_list = 2 | int64_list = 3 }
  BytesList{ value: repeated bytes = 1 }
  FloatList{ value: repeated float = 1 (packed or not) }
  Int64List{ value: repeated int64 = 1 (packed or not) }
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

from analytics_zoo_tpu_torch.tensorboard.record import (
    _field_bytes,
    _iter_fields,
    _varint,
    masked_crc,
    write_record,
)

__all__ = [
    "read_tfrecord_file", "parse_example", "encode_example",
    "tfrecord_loader", "imagenet_example_parser", "count_tfrecord_records",
]


def count_tfrecord_records(path: str) -> int:
    """Record count by walking the framing headers only — seeks past every
    payload, so sizing a shard costs ~16 bytes of IO per record (the cheap
    sizer for ShardedFeatureSet; no decode, no parse)."""
    import os

    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 8 <= size:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            pos += 8 + 4 + length + 4
            f.seek(pos)
            n += 1
    return n


# Buffered-read chunk: the framing walk used to issue FOUR tiny f.read
# calls per record (8B header, 4B crc, payload, 4B crc) — pure-python
# decode was syscall-bound before a single byte was parsed.  Reading the
# file in 1 MiB slabs and slicing records out of the buffer amortizes IO
# to ~one read per MiB.
_READ_CHUNK = 1 << 20


def _iter_frames(f, chunk_size: int = _READ_CHUNK, strict: bool = False):
    """Yield ``(header, hcrc, payload, dcrc)`` framing tuples from a
    binary stream using chunked buffered reads (no per-record syscalls).

    ``strict=False``: a truncated trailing record is dropped (the lenient
    read path); ``strict=True``: truncation raises — a caller asking for
    CRC verification must not get a silently shortened stream."""
    buf = bytearray()
    pos = 0
    eof = False

    def ensure(n: int) -> bool:
        nonlocal buf, pos, eof
        while len(buf) - pos < n and not eof:
            chunk = f.read(max(chunk_size, n))
            if not chunk:
                eof = True
                break
            if pos:
                del buf[:pos]
                pos = 0
            buf += chunk
        return len(buf) - pos >= n

    while True:
        if not ensure(12):
            if strict and len(buf) - pos > 0:
                raise ValueError("truncated record header")
            return
        header = bytes(buf[pos:pos + 8])
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack_from("<I", buf, pos + 8)
        pos += 12
        if not ensure(length + 4):
            if strict:
                raise ValueError("truncated record payload")
            return
        payload = bytes(buf[pos:pos + length])
        (dcrc,) = struct.unpack_from("<I", buf, pos + length)
        pos += length + 4
        yield header, hcrc, payload, dcrc


def read_tfrecord_file(path: str, verify_crc: bool = False,
                       chunk_size: int = _READ_CHUNK):
    """Yield raw record bytes from one TFRecord file (buffered: the file
    is read in ``chunk_size`` slabs, not four tiny reads per record).

    ``verify_crc=True`` checks the masked CRC32C of every record payload
    (the framing the reference writes via RecordWriter.scala; one shared
    table-driven CRC — record.py's — serves every record)."""
    with open(path, "rb") as f:
        try:
            for header, hcrc, data, dcrc in _iter_frames(
                    f, chunk_size, strict=verify_crc):
                if verify_crc:
                    if masked_crc(header) != hcrc:
                        raise ValueError(f"{path}: corrupt record header")
                    if masked_crc(data) != dcrc:
                        raise ValueError(
                            f"{path}: corrupt record payload")
                yield data
        except ValueError as e:
            if str(e).startswith("truncated"):
                raise ValueError(f"{path}: {e}") from None
            raise


def _decode_list(data: bytes, wire_hint: str):
    """Decode BytesList/FloatList/Int64List bodies (field 1, repeated)."""
    out = []
    for num, wire, val in _iter_fields(data):
        if num != 1:
            continue
        if wire_hint == "bytes":
            out.append(val)
        elif wire_hint == "float":
            if wire == 2:  # packed
                out.extend(np.frombuffer(val, "<f4").tolist())
            else:
                out.append(struct.unpack("<f", val)[0])
        else:  # int64
            if wire == 2:  # packed varints
                i = 0
                while i < len(val):
                    v = 0
                    shift = 0
                    while True:
                        b = val[i]
                        i += 1
                        v |= (b & 0x7F) << shift
                        if not b & 0x80:
                            break
                        shift += 7
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
            else:
                if val >= 1 << 63:
                    val -= 1 << 64
                out.append(val)
    return out


def parse_example(data: bytes) -> dict:
    """tf.train.Example bytes -> {name: list_of_values}.

    bytes features decode to ``bytes``; float/int64 features to python
    numbers — the caller's parse_fn shapes them (the role the reference
    delegates to user TF graph code in TFBytesDataset)."""
    out = {}
    for num, wire, val in _iter_fields(data):
        if num != 1 or wire != 2:
            continue  # Example.features
        for n2, w2, feat_map in _iter_fields(val):
            if n2 != 1 or w2 != 2:
                continue  # Features.feature map entry
            key, feature = None, None
            for n3, w3, v3 in _iter_fields(feat_map):
                if n3 == 1:
                    key = v3.decode()
                elif n3 == 2:
                    feature = v3
            if key is None or feature is None:
                continue
            for n4, w4, v4 in _iter_fields(feature):
                kind = {1: "bytes", 2: "float", 3: "int64"}.get(n4)
                if kind is not None:
                    out[key] = _decode_list(v4, kind)
    return out


def _encode_list(kind: str, values) -> bytes:
    body = b""
    if kind == "bytes":
        for v in values:
            body += _field_bytes(1, bytes(v))
    elif kind == "float":
        packed = struct.pack(f"<{len(values)}f", *values)
        body += _field_bytes(1, packed)
    else:
        packed = b"".join(_varint(v & ((1 << 64) - 1)) for v in values)
        body += _field_bytes(1, packed)
    return body


def encode_example(features: dict) -> bytes:
    """{name: list|bytes|ndarray} -> tf.train.Example bytes (for writing
    shards and fixtures; the reference relies on external tooling)."""
    feats = b""
    for key, values in features.items():
        if isinstance(values, bytes):
            kind, values = "bytes", [values]
        elif isinstance(values, np.ndarray):
            if np.issubdtype(values.dtype, np.integer):
                kind, values = "int64", values.ravel().tolist()
            else:
                kind, values = "float", values.ravel().tolist()
        elif values and isinstance(values[0], (bytes, bytearray)):
            kind = "bytes"
        elif values and isinstance(values[0], int):
            kind = "int64"
        else:
            kind = "float"
        field_num = {"bytes": 1, "float": 2, "int64": 3}[kind]
        feature = _field_bytes(field_num, _encode_list(kind, values))
        entry = _field_bytes(1, key.encode()) + _field_bytes(2, feature)
        feats += _field_bytes(1, entry)
    # Example.features (field 1) wraps the Features message, whose content
    # is the series of map entries already in `feats`.
    return _field_bytes(1, feats)


def write_tfrecord_file(path: str, examples) -> None:
    """Write encoded Example byte strings as a TFRecord file."""
    with open(path, "wb") as f:
        for ex in examples:
            write_record(f, ex)


def imagenet_example_parser(image_key: str = "image/encoded",
                            label_key: str = "image/class/label",
                            label_offset: int = 0,
                            image_size: int | None = None) -> Callable:
    """Parser for ImageNet-style TFRecords (JPEG bytes + int label) -> the
    (x, y) arrays FeatureSet batches carry.  ``image_size`` optionally
    resizes at load (uint8 out, normalization stays on device)."""

    def parse(feature_map: dict):
        import cv2

        buf = np.frombuffer(feature_map[image_key][0], np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1]  # RGB
        if image_size is not None:
            img = cv2.resize(img, (image_size, image_size),
                             interpolation=cv2.INTER_AREA)
        label = int(feature_map[label_key][0]) + label_offset
        return img.astype(np.uint8), np.int32(label)

    return parse


def tfrecord_loader(parse_fn: Callable) -> Callable:
    """Build a ShardedFeatureSet loader: one TFRecord file -> {"x", "y"}.

    ``parse_fn(feature_map) -> (x, y)`` per record."""

    def load(path: str) -> dict:
        xs, ys = [], []
        for rec in read_tfrecord_file(path):
            x, y = parse_fn(parse_example(rec))
            xs.append(x)
            ys.append(y)
        return {"x": np.stack(xs), "y": np.stack(ys)}

    return load
