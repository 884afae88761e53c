"""ONNX export of YuNet, emitted directly in protobuf wire format —
counterpart of ``yunet_tpu/export/onnx_export.py``, byte for byte.

The output contract of the reference exporter (tools/yunet2onnx.py:89-113
and the in-model export branch yunet_head.py:227-245): NCHW ``input``,
twelve outputs named {cls,obj,bbox,kps}_{8,16,32} with shape (B, HW, C),
sigmoid baked into the graph for cls/obj, optional dynamic batch/spatial
axes. BatchNorm is folded into the convolutions at export time.

The file is the JAX package's file from the same parameters: the same
nodes in the same order, the same fresh-name counter, attribute order,
int64 shape constants, ir_version 7, opset 11, and the producer and graph
name ``yunet_tpu`` (the file's contract, not the framework's). No onnx
dependency: the ModelProto is assembled with the codec in proto.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..models.fused import fold_conv_bn
from ..models.layers import ConvDPUnit
from .cpp_export import _np
from .proto import Message, encode_message


# the producer and graph name every file of this model family carries:
# the JAX package's name, part of the file's contract (not a path)
_NAME = b'yunet_tpu'


def _attr_int(name: str, v: int) -> bytes:
    return encode_message({1: [name.encode()], 20: [2], 3: [v]})


def _attr_ints(name: str, vs: Sequence[int]) -> bytes:
    return encode_message({1: [name.encode()], 20: [7],
                           8: [int(v) for v in vs]})


def _attr_str(name: str, v: str) -> bytes:
    return encode_message({1: [name.encode()], 20: [3], 4: [v.encode()]})


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    msg: Message = {1: [i.encode() for i in inputs],
                    2: [o.encode() for o in outputs],
                    4: [op.encode()]}
    if name:
        msg[3] = [name.encode()]
    if attrs:
        msg[5] = list(attrs)
    return encode_message(msg)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}[arr.dtype]
    return encode_message({
        1: [int(d) for d in arr.shape],
        2: [dt], 8: [name.encode()], 9: [arr.tobytes()]})


def _value_info(name: str, shape: Sequence[Any], elem: int = 1) -> bytes:
    dims = []
    for d in shape:
        if isinstance(d, str):
            dims.append(encode_message({2: [d.encode()]}))
        else:
            dims.append(encode_message({1: [int(d)]}))
    shape_msg = encode_message({1: dims})
    ttype = encode_message({1: [elem], 2: [shape_msg]})
    return encode_message({1: [name.encode()],
                           2: [encode_message({1: [ttype]})]})


class _GraphBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self.n = 0

    def fresh(self, stem: str) -> str:
        self.n += 1
        return f"{stem}_{self.n}"

    def const(self, stem: str, arr: np.ndarray) -> str:
        name = self.fresh(stem)
        self.inits.append(_tensor(name, arr))
        return name

    def conv(self, x: str, w_oihw: torch.Tensor, b: torch.Tensor, *,
             stride: int = 1, pad: int = 0, groups: int = 1,
             stem: str = "conv") -> str:
        w_oihw = _np(w_oihw)
        wn = self.const(stem + "_w", w_oihw)
        bn = self.const(stem + "_b", _np(b))
        out = self.fresh(stem)
        kh, kw = w_oihw.shape[2], w_oihw.shape[3]
        self.nodes.append(_node(
            "Conv", [x, wn, bn], [out], name=out, attrs=[
                _attr_ints("dilations", [1, 1]),
                _attr_int("group", groups),
                _attr_ints("kernel_shape", [kh, kw]),
                _attr_ints("pads", [pad, pad, pad, pad]),
                _attr_ints("strides", [stride, stride])]))
        return out

    def relu(self, x: str) -> str:
        out = self.fresh("relu")
        self.nodes.append(_node("Relu", [x], [out], name=out))
        return out

    def maxpool2(self, x: str) -> str:
        out = self.fresh("pool")
        self.nodes.append(_node("MaxPool", [x], [out], name=out, attrs=[
            _attr_ints("kernel_shape", [2, 2]),
            _attr_ints("strides", [2, 2]),
            _attr_ints("pads", [0, 0, 0, 0])]))
        return out

    def upsample2(self, x: str) -> str:
        roi = self.const("roi", np.zeros((0,), np.float32))
        scales = self.const("scales",
                            np.asarray([1, 1, 2, 2], np.float32))
        out = self.fresh("up")
        self.nodes.append(_node("Resize", [x, roi, scales], [out],
                                name=out, attrs=[
            _attr_str("coordinate_transformation_mode", "asymmetric"),
            _attr_str("mode", "nearest"),
            _attr_str("nearest_mode", "floor")]))
        return out

    def add(self, a: str, b: str) -> str:
        out = self.fresh("add")
        self.nodes.append(_node("Add", [a, b], [out], name=out))
        return out

    def head_out(self, x: str, ch: int, out_name: str,
                 sigmoid: bool) -> None:
        t = self.fresh("tr")
        self.nodes.append(_node("Transpose", [x], [t], name=t, attrs=[
            _attr_ints("perm", [0, 2, 3, 1])]))
        shape = self.const("shape", np.asarray([0, -1, ch], np.int64))
        if sigmoid:
            r = self.fresh("rs")
            self.nodes.append(_node("Reshape", [t, shape], [r], name=r))
            self.nodes.append(_node("Sigmoid", [r], [out_name],
                                    name=out_name))
        else:
            self.nodes.append(_node("Reshape", [t, shape], [out_name],
                                    name=out_name))


def _conv_dp(g: _GraphBuilder, x: str, unit: ConvDPUnit, stem: str) -> str:
    x = g.conv(x, unit.conv1.weight, unit.conv1.bias, stem=stem + "_pw")
    co = unit.conv2.weight.shape[0]
    if unit.bn is not None:
        w2, b2 = fold_conv_bn(unit.conv2.weight, unit.conv2.bias, unit.bn)
        x = g.conv(x, w2, b2, pad=1, groups=co, stem=stem + "_dw")
        return g.relu(x)
    return g.conv(x, unit.conv2.weight, unit.conv2.bias, pad=1, groups=co,
                  stem=stem + "_dw")


@torch.no_grad()
def export_onnx(model: nn.Module, cfg: ModelConfig, *,
                input_shape: Tuple[int, int] = (640, 640),
                dynamic: bool = False) -> bytes:
    """Build the ONNX ModelProto bytes of ``model`` (the port's YuNet,
    eval-mode BN statistics)."""
    g = _GraphBuilder()
    x = "input"

    bb = model.backbone
    # stem (Conv_head)
    m0 = bb.model0
    w2, b2 = fold_conv_bn(m0.conv1.weight, m0.conv1.bias, m0.bn1)
    x = g.relu(g.conv(x, w2, b2, stride=2, pad=1, stem="stem"))
    x = _conv_dp(g, x, m0.conv2, "stem_dp")

    feats: List[str] = []
    num_stages = len(cfg.stage_channels)
    for i in range(num_stages):
        if i > 0:
            m = getattr(bb, f"model{i}")
            x = _conv_dp(g, x, m.conv1, f"m{i}a")
            x = _conv_dp(g, x, m.conv2, f"m{i}b")
        if i in cfg.out_idx:
            feats.append(x)
        if i in cfg.downsample_idx:
            x = g.maxpool2(x)

    # TFPN top-down
    lateral = model.neck.lateral_convs
    for i in range(len(feats) - 1, 0, -1):
        feats[i] = _conv_dp(g, feats[i], lateral[i], f"lat{i}")
        feats[i - 1] = g.add(feats[i - 1], g.upsample2(feats[i]))
    feats[0] = _conv_dp(g, feats[0], lateral[0], "lat0")

    # head
    head = model.bbox_head
    outs: Dict[str, List[str]] = {"cls": [], "obj": [], "bbox": [],
                                  "kps": []}
    for lvl, f in enumerate(feats):
        if head.multi_level_share_convs is not None:
            for j, unit in enumerate(head.multi_level_share_convs[lvl]):
                f = _conv_dp(g, f, unit, f"share{lvl}_{j}")
        for key in head.branches:
            outs[key].append(_conv_dp(
                g, f, getattr(head, f"multi_level_{key}")[lvl],
                f"{key}{lvl}"))

    h, w = input_shape
    output_infos = []
    for key, sigmoid, ch in (("cls", True, cfg.num_classes),
                             ("obj", True, 1), ("bbox", False, 4),
                             ("kps", False, cfg.kps_num * 2)):
        for lvl, stride in enumerate(cfg.strides):
            name = f"{key}_{stride}"
            g.head_out(outs[key][lvl], ch, name, sigmoid)
            hw = (h // stride) * (w // stride)
            shape = ["batch", "hw", ch] if dynamic else [1, hw, ch]
            output_infos.append(_value_info(name, shape))

    in_shape = (["batch", 3, "height", "width"] if dynamic
                else [1, 3, h, w])
    graph = encode_message({
        1: g.nodes,
        2: [_NAME],
        5: g.inits,
        11: [_value_info("input", in_shape)],
        12: output_infos,
    })
    model_proto = encode_message({
        1: [7],                       # ir_version
        2: [_NAME],                   # producer_name
        7: [graph],
        8: [encode_message({1: [b""], 2: [11]})],  # opset 11
    })
    return model_proto
