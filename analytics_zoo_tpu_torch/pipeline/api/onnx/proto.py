"""Minimal ONNX protobuf wire-format codec (no ``onnx`` dependency).

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/proto.py``, kept as
the port's own copy: it reads and writes the protobuf wire format
directly with the stable ONNX field numbers (onnx/onnx.proto; field ids
are frozen by protobuf compatibility rules), so the ONNX loader, the
exporter and the caffemodel reader need no protobuf runtime.  The bytes
it writes for a model equal the JAX package's for the same model.

Only the subset needed for inference graphs is modeled: ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out, value):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as memoryview slices."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wtype == 5:  # 32-bit
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _field(out: bytearray, fnum, wtype):
    _write_varint(out, (fnum << 3) | wtype)


def _put_bytes(out, fnum, data):
    _field(out, fnum, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_varint(out, fnum, value):
    _field(out, fnum, 0)
    _write_varint(out, value)


def _packed_or_repeated_ints(val, wtype):
    if wtype == 2:  # packed
        vals, pos = [], 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            vals.append(v)
        return vals
    return [val]


def _unzigzag_signed(v, bits=64):
    """Protobuf int64 fields store negatives as 10-byte two's complement
    varints; fold back into Python ints."""
    if v >= (1 << (bits - 1)):
        v -= 1 << bits
    return v


# ---------------------------------------------------------------------------
# ONNX messages (field numbers from onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, DOUBLE = 1, 2, 3, 6, 7, 9, 11
_DTYPES = {FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8,
           INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
           DOUBLE: np.float64}
_NP2ONNX = {np.dtype(np.float32): FLOAT, np.dtype(np.int64): INT64,
            np.dtype(np.int32): INT32, np.dtype(np.float64): DOUBLE,
            np.dtype(np.bool_): BOOL}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


@dataclass
class Tensor:
    name: str = ""
    array: np.ndarray | None = None


@dataclass
class Attribute:
    name: str = ""
    value: object = None


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str = ""
    shape: tuple = ()
    elem_type: int = FLOAT


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> np.ndarray
    inputs: list = field(default_factory=list)        # ValueInfo
    outputs: list = field(default_factory=list)       # ValueInfo


@dataclass
class Model:
    ir_version: int = 8
    opset: int = 13
    graph: Graph = field(default_factory=Graph)


# -- decoding ---------------------------------------------------------------

def _decode_tensor(buf) -> Tensor:
    dims, dtype, raw = [], FLOAT, None
    f32, i32, i64, f64 = [], [], [], []
    name = ""
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.extend(_unzigzag_signed(v)
                        for v in _packed_or_repeated_ints(val, wtype))
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wtype == 2:
                f32.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                f32.append(struct.unpack("<f", struct.pack("<i", val))[0])
        elif fnum == 5:
            i32.extend(_packed_or_repeated_ints(val, wtype))
        elif fnum == 7:
            i64.extend(_unzigzag_signed(v)
                       for v in _packed_or_repeated_ints(val, wtype))
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:
            if wtype == 2:
                f64.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                f64.append(struct.unpack("<d", struct.pack("<q", val))[0])
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype {dtype} ({name})")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).copy()
    elif f32:
        arr = np.asarray(f32, dtype=np_dtype)
    elif i64:
        arr = np.asarray(i64, dtype=np_dtype)
    elif i32:
        arr = np.asarray(i32, dtype=np_dtype)
    elif f64:
        arr = np.asarray(f64, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return Tensor(name, arr.reshape(dims))


def _decode_attribute(buf) -> Attribute:
    a = Attribute()
    atype = None
    ints, floats, strings = [], [], []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = val.decode()
        elif fnum == 2:
            a.value = struct.unpack("<f", struct.pack("<i", val))[0] \
                if wtype == 5 else val
        elif fnum == 3:
            a.value = _unzigzag_signed(val)
        elif fnum == 4:
            a.value = val.decode()
        elif fnum == 5:
            a.value = _decode_tensor(val).array
        elif fnum == 7:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(
                    struct.unpack("<f", struct.pack("<i", val))[0]
                )
        elif fnum == 8:
            ints.extend(_unzigzag_signed(v)
                        for v in _packed_or_repeated_ints(val, wtype))
        elif fnum == 9:
            strings.append(val.decode())
        elif fnum == 20:
            atype = val
    if atype == ATTR_INTS or (ints and a.value is None):
        a.value = ints
    elif atype == ATTR_FLOATS or (floats and a.value is None):
        a.value = floats
    elif atype == ATTR_STRINGS or (strings and a.value is None):
        a.value = strings
    elif a.value is None:
        # proto3 writers omit zero-valued scalar fields; restore the
        # type's zero default so e.g. Gather axis=0 decodes as 0, not None
        a.value = {ATTR_INT: 0, ATTR_FLOAT: 0.0,
                   ATTR_STRING: ""}.get(atype)
    return a


def _decode_node(buf) -> Node:
    n = Node()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode())
        elif fnum == 2:
            n.outputs.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            a = _decode_attribute(val)
            n.attrs[a.name] = a.value
    return n


def _decode_value_info(buf) -> ValueInfo:
    vi = ValueInfo()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    dims = []
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # shape
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dim_val = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = v5
                                    dims.append(dim_val)
                    vi.shape = tuple(dims)
    return vi


def _decode_graph(buf) -> Graph:
    g = Graph()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_decode_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            t = _decode_tensor(val)
            g.initializers[t.name] = t.array
        elif fnum == 11:
            g.inputs.append(_decode_value_info(val))
        elif fnum == 12:
            g.outputs.append(_decode_value_info(val))
    return g


def decode_model(data: bytes) -> Model:
    m = Model()
    for fnum, _, val in _iter_fields(memoryview(data)):
        if fnum == 1:
            m.ir_version = val
        elif fnum == 7:
            m.graph = _decode_graph(val)
        elif fnum == 8:  # opset_import
            for f2, _, v2 in _iter_fields(val):
                if f2 == 2:
                    m.opset = _unzigzag_signed(v2)
    return m


# -- encoding (used by the test suite to fabricate models) ------------------

def _encode_tensor(name, arr) -> bytes:
    out = bytearray()
    arr = np.asarray(arr)
    for d in arr.shape:
        _put_varint(out, 1, d)
    _put_varint(out, 2, _NP2ONNX[arr.dtype])
    _put_bytes(out, 8, name.encode())
    _put_bytes(out, 9, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _encode_attribute(name, value) -> bytes:
    out = bytearray()
    _put_bytes(out, 1, name.encode())
    if isinstance(value, bool):
        _put_varint(out, 3, int(value))
        _put_varint(out, 20, ATTR_INT)
    elif isinstance(value, int):
        _put_varint(out, 3, value & ((1 << 64) - 1))
        _put_varint(out, 20, ATTR_INT)
    elif isinstance(value, float):
        _field(out, 2, 5)
        out.extend(struct.pack("<f", value))
        _put_varint(out, 20, ATTR_FLOAT)
    elif isinstance(value, str):
        _put_bytes(out, 4, value.encode())
        _put_varint(out, 20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        _put_bytes(out, 5, _encode_tensor("", value))
        _put_varint(out, 20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and \
            isinstance(value[0], float):
        for v in value:
            _field(out, 7, 5)
            out.extend(struct.pack("<f", v))
        _put_varint(out, 20, ATTR_FLOATS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _put_varint(out, 8, int(v) & ((1 << 64) - 1))
        _put_varint(out, 20, ATTR_INTS)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return bytes(out)


def _encode_node(node: Node) -> bytes:
    out = bytearray()
    for i in node.inputs:
        _put_bytes(out, 1, i.encode())
    for o in node.outputs:
        _put_bytes(out, 2, o.encode())
    if node.name:
        _put_bytes(out, 3, node.name.encode())
    _put_bytes(out, 4, node.op_type.encode())
    for k, v in node.attrs.items():
        _put_bytes(out, 5, _encode_attribute(k, v))
    return bytes(out)


def _encode_value_info(vi: ValueInfo) -> bytes:
    shape = bytearray()
    for d in vi.shape:
        dim = bytearray()
        if d is not None:
            _put_varint(dim, 1, d)
        _put_bytes(shape, 1, bytes(dim))
    ttype = bytearray()
    _put_varint(ttype, 1, vi.elem_type)
    _put_bytes(ttype, 2, bytes(shape))
    tproto = bytearray()
    _put_bytes(tproto, 1, bytes(ttype))
    out = bytearray()
    _put_bytes(out, 1, vi.name.encode())
    _put_bytes(out, 2, bytes(tproto))
    return bytes(out)


def encode_model(model: Model) -> bytes:
    g = bytearray()
    for n in model.graph.nodes:
        _put_bytes(g, 1, _encode_node(n))
    _put_bytes(g, 2, (model.graph.name or "graph").encode())
    for name, arr in model.graph.initializers.items():
        _put_bytes(g, 5, _encode_tensor(name, arr))
    for vi in model.graph.inputs:
        _put_bytes(g, 11, _encode_value_info(vi))
    for vi in model.graph.outputs:
        _put_bytes(g, 12, _encode_value_info(vi))

    out = bytearray()
    _put_varint(out, 1, model.ir_version)
    opset = bytearray()
    _put_varint(opset, 2, model.opset)
    _put_bytes(out, 8, bytes(opset))
    _put_bytes(out, 7, bytes(g))
    return bytes(out)
