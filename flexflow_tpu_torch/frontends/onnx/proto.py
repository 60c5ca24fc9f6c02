"""A minimal ONNX protobuf wire-format codec (no `onnx` package needed).

The PyTorch port's copy of flexflow_tpu/frontends/onnx/proto.py: the
same encoding field for field, so each package reads the other's files
and writes the same bytes for the same model. The reference's ONNX
frontend (python/flexflow/onnx/model.py:56) loads ModelProto files with
the `onnx` pip package; this module implements the subset of the ONNX
schema the frontend reads -- ModelProto / GraphProto / NodeProto /
AttributeProto / TensorProto / ValueInfoProto -- directly over the protobuf wire format (varints and
length-delimited fields). Files written by `save_model` are real protobuf
and load with stock `onnx.load`; files exported by other tools parse
here, unknown fields skipped.

It also provides `onnx.helper`/`numpy_helper`-style constructors
(make_node, make_graph, make_model, make_tensor_value_info, from_array,
to_array), so code that builds a graph reads like standard onnx code.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # two's-complement like protobuf int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return result, pos


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _emit_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _emit_len(out: bytearray, field: int, payload: bytes) -> None:
    _emit_tag(out, field, _WIRE_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
        elif wire == _WIRE_64BIT:
            v = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == _WIRE_32BIT:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


# ---------------------------------------------------------------------------
# declarative message framework
# ---------------------------------------------------------------------------
# FIELDS: {field_no: (attr_name, kind, repeated)} with kind one of
# "int", "float" (32-bit), "bytes", "string", or a Message subclass.


class Message:
    FIELDS: Dict[int, tuple] = {}

    def __init__(self, **kw):
        for _, (name, kind, rep) in self.FIELDS.items():
            default = [] if rep else (
                0 if kind == "int" else
                0.0 if kind == "float" else
                b"" if kind == "bytes" else
                "" if kind == "string" else None
            )
            setattr(self, name, kw.pop(name, default))
        if kw:
            raise TypeError(
                f"unknown fields {list(kw)} for {type(self).__name__}")

    # -- serialize ------------------------------------------------------
    def dumps(self) -> bytes:
        out = bytearray()
        for field, (name, kind, rep) in sorted(self.FIELDS.items()):
            val = getattr(self, name)
            vals = val if rep else ([val] if self._is_set(val, kind) else [])
            for v in vals:
                if kind == "int":
                    _emit_tag(out, field, _WIRE_VARINT)
                    _write_varint(out, int(v))
                elif kind == "float":
                    _emit_tag(out, field, _WIRE_32BIT)
                    out.extend(struct.pack("<f", float(v)))
                elif kind == "bytes":
                    _emit_len(out, field, bytes(v))
                elif kind == "string":
                    _emit_len(out, field, str(v).encode("utf-8"))
                else:  # nested message
                    _emit_len(out, field, v.dumps())
        return bytes(out)

    @staticmethod
    def _is_set(val, kind) -> bool:
        if val is None:
            return False
        if kind == "int":
            return val != 0
        if kind == "float":
            return val != 0.0
        if kind in ("bytes", "string"):
            return len(val) > 0
        return True

    # -- parse ----------------------------------------------------------
    @classmethod
    def parse(cls, buf: bytes):
        self = cls()
        for field, wire, raw in _iter_fields(buf):
            spec = cls.FIELDS.get(field)
            if spec is None:
                continue  # unknown field: skip (forward compatible)
            name, kind, rep = spec
            if kind == "int":
                if wire == _WIRE_LEN:  # packed repeated varints
                    vals, pos = [], 0
                    while pos < len(raw):
                        v, pos = _read_varint(raw, pos)
                        vals.append(_signed64(v))
                    if rep:
                        getattr(self, name).extend(vals)
                        continue
                    v = vals[-1] if vals else 0
                else:
                    v = _signed64(raw)
            elif kind == "float":
                if wire == _WIRE_LEN:  # packed repeated floats
                    vals = list(struct.unpack(f"<{len(raw) // 4}f", raw))
                    if rep:
                        getattr(self, name).extend(vals)
                        continue
                    v = vals[-1] if vals else 0.0
                else:
                    v = struct.unpack("<f", raw)[0]
            elif kind == "bytes":
                v = bytes(raw)
            elif kind == "string":
                v = raw.decode("utf-8")
            else:
                v = kind.parse(raw)
            if rep:
                getattr(self, name).append(v)
            else:
                setattr(self, name, v)
        return self

    def __repr__(self):
        parts = []
        for _, (name, _, _) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if isinstance(v, (list, bytes)) and len(v) > 8:
                v = f"<{len(v)} items>"
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# ---------------------------------------------------------------------------
# ONNX schema subset (field numbers from onnx/onnx.proto)
# ---------------------------------------------------------------------------


class TensorProto(Message):
    # data_type enum values (onnx.proto TensorProto.DataType)
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
    BFLOAT16 = 16

    FIELDS = {
        1: ("dims", "int", True),
        2: ("data_type", "int", False),
        4: ("float_data", "float", True),
        5: ("int32_data", "int", True),
        7: ("int64_data", "int", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
    }


_NP_OF_DT = {
    TensorProto.FLOAT: np.float32,
    TensorProto.UINT8: np.uint8,
    TensorProto.INT8: np.int8,
    TensorProto.INT32: np.int32,
    TensorProto.INT64: np.int64,
    TensorProto.BOOL: np.bool_,
    TensorProto.FLOAT16: np.float16,
    TensorProto.DOUBLE: np.float64,
}
_DT_OF_NP = {np.dtype(v): k for k, v in _NP_OF_DT.items()}


class AttributeProto(Message):
    # AttributeType enum
    FLOAT, INT, STRING, TENSOR = 1, 2, 3, 4
    FLOATS, INTS, STRINGS, TENSORS = 6, 7, 8, 9

    FIELDS = {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int", False),
        4: ("s", "bytes", False),
        5: ("t", TensorProto, False),
        7: ("floats", "float", True),
        8: ("ints", "int", True),
        9: ("strings", "bytes", True),
        20: ("type", "int", False),
    }


class NodeProto(Message):
    FIELDS = {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", AttributeProto, True),
        7: ("domain", "string", False),
    }


class _Dim(Message):
    FIELDS = {1: ("dim_value", "int", False),
              2: ("dim_param", "string", False)}


class _Shape(Message):
    FIELDS = {1: ("dim", _Dim, True)}


class _TensorTypeProto(Message):
    FIELDS = {1: ("elem_type", "int", False), 2: ("shape", _Shape, False)}


class TypeProto(Message):
    FIELDS = {1: ("tensor_type", _TensorTypeProto, False)}


class ValueInfoProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("type", TypeProto, False),
    }


class GraphProto(Message):
    FIELDS = {
        1: ("node", NodeProto, True),
        2: ("name", "string", False),
        5: ("initializer", TensorProto, True),
        11: ("input", ValueInfoProto, True),
        12: ("output", ValueInfoProto, True),
        13: ("value_info", ValueInfoProto, True),
    }


class OperatorSetIdProto(Message):
    FIELDS = {1: ("domain", "string", False), 2: ("version", "int", False)}


class ModelProto(Message):
    FIELDS = {
        1: ("ir_version", "int", False),
        2: ("producer_name", "string", False),
        7: ("graph", GraphProto, False),
        8: ("opset_import", OperatorSetIdProto, True),
    }


# ---------------------------------------------------------------------------
# onnx.helper / onnx.numpy_helper equivalents
# ---------------------------------------------------------------------------


def from_array(arr: np.ndarray, name: str = "") -> TensorProto:
    arr = np.asarray(arr)
    dt = _DT_OF_NP[arr.dtype]
    return TensorProto(
        dims=list(arr.shape), data_type=dt, name=name,
        raw_data=arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes(),
    )


def to_array(t) -> np.ndarray:
    """Decode a TensorProto (ours OR the onnx package's) to numpy."""
    dims = list(t.dims)
    dt = _NP_OF_DT.get(int(t.data_type), np.float32)
    raw = bytes(t.raw_data) if t.raw_data else b""
    if raw:
        return np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<")
                             ).reshape(dims).copy()
    for field in ("float_data", "int64_data", "int32_data"):
        data = list(getattr(t, field, []) or [])
        if data:
            return np.asarray(data, dtype=dt).reshape(dims)
    return np.zeros(dims, dtype=dt)


def make_node(op_type: str, inputs: List[str], outputs: List[str],
              name: str = "", **attrs) -> NodeProto:
    node = NodeProto(input=list(inputs), output=list(outputs), name=name,
                     op_type=op_type)
    for k, v in attrs.items():
        node.attribute.append(_make_attr(k, v))
    return node


def _make_attr(name: str, v) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(v, TensorProto):
        a.type, a.t = AttributeProto.TENSOR, v
    elif isinstance(v, bool) or isinstance(v, (int, np.integer)):
        a.type, a.i = AttributeProto.INT, int(v)
    elif isinstance(v, (float, np.floating)):
        a.type, a.f = AttributeProto.FLOAT, float(v)
    elif isinstance(v, (str, bytes)):
        a.type = AttributeProto.STRING
        a.s = v.encode() if isinstance(v, str) else v
    elif isinstance(v, (list, tuple)):
        if all(isinstance(x, (int, np.integer)) for x in v):
            a.type = AttributeProto.INTS
            a.ints = [int(x) for x in v]
        else:
            a.type = AttributeProto.FLOATS
            a.floats = [float(x) for x in v]
    else:
        raise TypeError(f"attribute {name}: unsupported {type(v)}")
    return a


def make_tensor_value_info(name: str, elem_type: int,
                           shape) -> ValueInfoProto:
    dims = [
        _Dim(dim_param=d) if isinstance(d, str) else _Dim(dim_value=int(d))
        for d in (shape or [])
    ]
    return ValueInfoProto(
        name=name,
        type=TypeProto(tensor_type=_TensorTypeProto(
            elem_type=elem_type, shape=_Shape(dim=dims))),
    )


def make_graph(nodes, name, inputs, outputs, initializer=None) -> GraphProto:
    return GraphProto(node=list(nodes), name=name, input=list(inputs),
                      output=list(outputs),
                      initializer=list(initializer or []))


def make_model(graph: GraphProto, producer_name: str = "flexflow_tpu_torch",
               opset: int = 14) -> ModelProto:
    return ModelProto(ir_version=8, producer_name=producer_name, graph=graph,
                      opset_import=[OperatorSetIdProto(domain="",
                                                       version=opset)])


def save_model(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.dumps())


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return ModelProto.parse(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return ModelProto.parse(f.read())
