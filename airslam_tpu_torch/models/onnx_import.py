"""ONNX graphs read without the ``onnx`` package.

The port's own copy of ``airslam_tpu/models/onnx_import.py`` (numpy only):
the upstream AirSLAM models ship as ONNX files (``plnet_s1.onnx``, the
stage-1 LOI head), and this module parses the protobuf wire format directly.
:func:`load_onnx` returns the initializers (the trained weights) and the
count of each op; :func:`load_onnx_graph` the whole graph, which
``models/onnx_exec.py`` executes.

Wire-format subset (onnx.proto3):
  ModelProto.graph        = field 7  (LEN)
  GraphProto.node         = field 1  (LEN, repeated NodeProto)
  GraphProto.initializer  = field 5  (LEN, repeated TensorProto)
  GraphProto.input/output = fields 11/12 (LEN, ValueInfoProto; name = 1)
  NodeProto               = input 1, output 2, name 3, op_type 4, attribute 5
  AttributeProto          = name 1, f 2, i 3, t 5, floats 7, ints 8
  TensorProto             = dims 1, data_type 2 (1 f32, 6 i32, 7 i64, 9 bool,
                            10 f16, 11 f64), float_data 4, name 8, raw_data 9
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
          11: np.float64}


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field number, wire type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i: i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            val = buf[i: i + 4]
            i += 4
        elif wt == 1:  # 64-bit
            val = buf[i: i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_tensor(buf: bytes):
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = b""
    floats: List[float] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            if wt == 0:
                dims.append(val)
            else:  # packed
                i = 0
                while i < len(val):
                    v, i = _read_varint(val, i)
                    dims.append(v)
        elif field == 2 and wt == 0:
            dtype = val
        elif field == 4 and wt == 2:
            floats.extend(np.frombuffer(val, np.float32).tolist())
        elif field == 8 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif field == 9 and wt == 2:
            raw = val
    np_dtype = DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    else:
        arr = np.zeros(0, np_dtype)
    # no dims field is a rank-0 scalar in protobuf, so always reshape
    if arr.size == int(np.prod(dims, dtype=np.int64)):
        arr = arr.reshape(dims)
    return name, arr


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf: bytes):
    name = ""
    val = None
    ints: List[int] = []
    floats: List[float] = []
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == 2 and wt == 5:
            val = np.frombuffer(v, np.float32)[0]
        elif field == 3 and wt == 0:
            val = _signed(v)
        elif field == 5 and wt == 2:
            val = _parse_tensor(v)[1]
        elif field == 7:
            if wt == 5:
                floats.append(np.frombuffer(v, np.float32)[0])
            else:
                floats.extend(np.frombuffer(v, np.float32).tolist())
        elif field == 8 and wt == 0:
            ints.append(_signed(v))
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: bytes):
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op = ""
    attrs: Dict[str, object] = {}
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            inputs.append(v.decode("utf-8", "replace"))
        elif field == 2 and wt == 2:
            outputs.append(v.decode("utf-8", "replace"))
        elif field == 3 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == 4 and wt == 2:
            op = v.decode("utf-8", "replace")
        elif field == 5 and wt == 2:
            k, av = _parse_attr(v)
            attrs[k] = av
    return {"op": op, "name": name, "inputs": inputs, "outputs": outputs, "attrs": attrs}


def _graph(path: str) -> bytes:
    with open(path, "rb") as f:
        model = f.read()
    for field, wt, val in _fields(model):
        if field == 7 and wt == 2:
            return val
    raise ValueError("no GraphProto in model")


def _value_info_name(buf: bytes) -> str:
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            return v.decode("utf-8", "replace")
    return ""


def load_onnx_graph(path: str):
    """(nodes, initializers, graph inputs, graph outputs) of the model at
    ``path``. Nodes are dicts (op, name, inputs, outputs, attrs) in file
    (topological) order; a Constant node carries its tensor in
    ``attrs["value"]``."""
    nodes = []
    inits: Dict[str, np.ndarray] = {}
    g_in: List[str] = []
    g_out: List[str] = []
    for field, wt, val in _fields(_graph(path)):
        if field == 1 and wt == 2:
            nodes.append(_parse_node(val))
        elif field == 5 and wt == 2:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif field == 11 and wt == 2:
            g_in.append(_value_info_name(val))
        elif field == 12 and wt == 2:
            g_out.append(_value_info_name(val))
    return nodes, inits, g_in, g_out


def load_onnx(path: str):
    """(weights {name: ndarray}, op counts {op_type: count}) of the model at
    ``path``."""
    weights: Dict[str, np.ndarray] = {}
    ops: Dict[str, int] = {}
    for field, wt, val in _fields(_graph(path)):
        if field == 5 and wt == 2:
            name, arr = _parse_tensor(val)
            weights[name] = arr
        elif field == 1 and wt == 2:
            for f2, w2, v2 in _fields(val):
                if f2 == 4 and w2 == 2:
                    op = v2.decode("utf-8", "replace")
                    ops[op] = ops.get(op, 0) + 1
    return weights, ops
