"""ONNX model reader built on the minimal protobuf codec.

Used for golden-model tests (parsing the reference's shipped onnx/*.onnx
exports and checking weight/graph parity) and by the export round-trip
tests. Covers the subset of ONNX emitted by the YuNet exporters.

Field numbers follow onnx.proto3:
  ModelProto:  1 ir_version, 2 producer_name, 7 graph, 8 opset_import
  GraphProto:  1 node, 2 name, 5 initializer, 11 input, 12 output
  NodeProto:   1 input*, 2 output*, 3 name, 4 op_type, 5 attribute*
  TensorProto: 1 dims*, 2 data_type, 4 float_data*, 7 int64_data*,
               8 name(bytes)... actually 8 is name, 9 raw_data
  AttributeProto: 1 name, 2 f, 3 i, 4 s, 5 t, 6 g, 7 floats*, 8 ints*,
               20 type
  ValueInfoProto: 1 name, 2 type; TypeProto: 1 tensor_type;
  TypeProto.Tensor: 1 elem_type, 2 shape; TensorShapeProto: 1 dim;
  Dimension: 1 dim_value, 2 dim_param
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from .proto import (decode_message, get_bytes, get_int, get_ints, get_str,
                    get_strs, sub, sub1)

DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
          7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]
    input_shapes: Dict[str, List[Any]] = field(default_factory=dict)
    output_shapes: Dict[str, List[Any]] = field(default_factory=dict)


def _tensor(msg) -> np.ndarray:
    dims = get_ints(msg, 1)
    dt = DTYPES[get_int(msg, 2, 1)]
    raw = get_bytes(msg, 9)
    if raw:
        arr = np.frombuffer(raw, dtype=dt)
    elif 4 in msg:  # packed float_data
        data = msg[4]
        if len(data) == 1 and isinstance(data[0], bytes):
            arr = np.frombuffer(data[0], np.float32)
        else:
            arr = np.asarray([struct.unpack("<f", v[1])[0]
                              if isinstance(v, tuple) else v
                              for v in data], np.float32)
    elif 7 in msg:
        data = msg[7]
        if len(data) == 1 and isinstance(data[0], bytes):
            # packed varints
            from .proto import decode_varint
            buf, pos, vals = data[0], 0, []
            while pos < len(buf):
                v, pos = decode_varint(buf, pos)
                vals.append(v)
            arr = np.asarray(vals, np.int64)
        else:
            arr = np.asarray(data, np.int64)
    else:
        arr = np.zeros(0, dt)
    # dims == [] is a genuine 0-d scalar tensor (e.g. torch's Gather
    # indices in dynamic-axes exports) — reshape unconditionally so rank
    # semantics of downstream ops (Gather/Unsqueeze) are correct.
    return arr.reshape(tuple(dims)) if arr.size else arr.reshape(dims or [0])


def _tensor_name(msg) -> str:
    return get_str(msg, 8)


def _attr(msg) -> Dict[str, Any]:
    name = get_str(msg, 1)
    atype = get_int(msg, 20)
    if atype == 1:    # FLOAT
        v = msg.get(2, [(5, b"\0\0\0\0")])[0]
        value = struct.unpack("<f", v[1])[0] if isinstance(v, tuple) else v
    elif atype == 2:  # INT
        value = get_int(msg, 3)
    elif atype == 3:  # STRING
        value = get_bytes(msg, 4).decode(errors="replace")
    elif atype == 4:  # TENSOR
        value = _tensor(sub1(msg, 5))
    elif atype == 6:  # FLOATS
        data = msg.get(7, [])
        if len(data) == 1 and isinstance(data[0], bytes):
            value = list(np.frombuffer(data[0], np.float32))
        else:
            value = [struct.unpack("<f", v[1])[0] for v in data]
    elif atype == 7:  # INTS
        data = msg.get(8, [])
        if len(data) == 1 and isinstance(data[0], bytes):
            from .proto import decode_varint
            buf, pos, vals = data[0], 0, []
            while pos < len(buf):
                v, pos = decode_varint(buf, pos)
                vals.append(v)
            value = vals
        else:
            value = list(data)
    else:
        value = None
    return {name: value}


def _value_info_shape(msg) -> List[Any]:
    ttype = sub1(sub1(msg, 2), 1)      # type.tensor_type
    shape = sub1(ttype, 2)             # .shape
    dims = []
    for d in sub(shape, 1):
        if 1 in d:
            dims.append(get_int(d, 1))
        else:
            dims.append(get_str(d, 2))
    return dims


def read_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        model = decode_message(f.read())
    graph = sub1(model, 7)
    nodes = []
    for n in sub(graph, 1):
        attrs: Dict[str, Any] = {}
        for a in sub(n, 5):
            attrs.update(_attr(a))
        nodes.append(OnnxNode(
            op_type=get_str(n, 4), name=get_str(n, 3),
            inputs=get_strs(n, 1), outputs=get_strs(n, 2), attrs=attrs))
    inits = {}
    for t in sub(graph, 5):
        inits[_tensor_name(t)] = _tensor(t)
    g = OnnxGraph(
        name=get_str(graph, 2), nodes=nodes, initializers=inits,
        inputs=[], outputs=[])
    for vi in sub(graph, 11):
        name = get_str(vi, 1)
        g.inputs.append(name)
        g.input_shapes[name] = _value_info_shape(vi)
    for vi in sub(graph, 12):
        name = get_str(vi, 1)
        g.outputs.append(name)
        g.output_shapes[name] = _value_info_shape(vi)
    return g
