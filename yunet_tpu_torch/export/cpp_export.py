"""C++ weight-file generation for libfacedetection — counterpart of
``yunet_tpu/export/cpp_export.py``.

Writes a ``facedetectcnn-data.cpp`` with the layout contract of the
reference exporter (tools/yunet2cpp.py:42-160):
  * Conv+BN folded into conv weights/bias (``models/fused.py:
    fold_conv_bn``, bit-equal to the JAX package's numpy fold);
  * module walk order = torch named_children order (backbone stages, neck
    lateral convs, head share/cls/bbox/obj/kps branches per level);
  * pointwise weights serialized in OIHW order; depthwise weights as
    (9, C), kernel-position-major; the stem's 3x3x3 conv repacked
    position-major and zero-padded to a 32-channel layout;
  * '%.3g' float formatting with the '.f'/'f' suffix convention and the
    ConvInfoStruct table.

Walks the port's ``YuNet`` module; its weights are OIHW, so each layout
is reached by another transpose than JAX's (HWIO), to the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..models.fused import fold_conv_bn
from ..models.layers import ConvDPUnit

HEADER = (
    "// Auto generated data file\n"
    "// Copyright (c) 2018-2023, Shiqi Yu, all rights reserved.\n"
    "#include \"facedetectcnn.h\"\n\n")


def _fmt(v: float, precision: str = ".3g") -> str:
    s = format(float(v), precision)
    if "." not in s and "e" not in s:
        return s + ".f"
    return s + "f"


def _np(t: torch.Tensor) -> np.ndarray:
    """A weight as an f32 host array (the exporters' common input)."""
    return t.detach().cpu().float().numpy()


def _serialize(w_oihw: torch.Tensor, b: torch.Tensor, name: str, *,
               depthwise: bool, with_bn: bool,
               first3x3x3: bool) -> Dict[str, Any]:
    w_oihw = _np(w_oihw)
    co, ci, kh, kw = w_oihw.shape
    if first3x3x3:
        # position-major (k*3 + i) rows, zero-padded 27 -> 32
        w = np.transpose(w_oihw, (0, 2, 3, 1)).reshape(co, 27)
        w = np.hstack([w, np.zeros((co, 5), np.float32)]).reshape(-1)
        weight_size = f"{co}*32*1*1"
        in_ch = 32
    elif depthwise:
        # (9, C) kernel-position-major
        w = w_oihw.reshape(co, kh * kw).T.reshape(-1)
        weight_size = f"{co}*{1}*{kh}*{kw}"
        in_ch = co
    else:
        w = w_oihw.reshape(-1)
        weight_size = f"{co}*{ci}*{kh}*{kw}"
        in_ch = ci
    return {
        "weight_name": f"{name}_weight", "weight_size": weight_size,
        "weight": ",".join(_fmt(v) for v in w),
        "bias_name": f"{name}_bias", "bias_size": str(co),
        "bias": ",".join(_fmt(v) for v in _np(b).reshape(-1)),
        "with_bn": with_bn, "is_dw": depthwise,
        "in_channels": in_ch, "out_channels": co,
    }


def _emit_conv_dp(entries, unit: ConvDPUnit, name: str) -> None:
    """ConvDPUnit: pointwise (raw) + depthwise (BN-folded when present)."""
    entries.append(_serialize(unit.conv1.weight, unit.conv1.bias,
                              name + "_pw", depthwise=False, with_bn=False,
                              first3x3x3=False))
    wd, bd = unit.conv2.weight, unit.conv2.bias
    if unit.bn is not None:
        wd, bd = fold_conv_bn(wd, bd, unit.bn)
    entries.append(_serialize(wd, bd, name + "_dw", depthwise=True,
                              with_bn=unit.bn is not None,
                              first3x3x3=False))


def walk_modules(model: nn.Module, cfg: ModelConfig
                 ) -> Iterator[Tuple[str, str, nn.Module]]:
    """Yield (name, kind, module) in the reference's module discovery
    order."""
    bb = model.backbone
    yield ("backbone__model0", "conv_head", bb.model0)
    for i in range(1, len(cfg.stage_channels)):
        yield (f"backbone__model{i}", "conv4layer", getattr(bb, f"model{i}"))
    for i, unit in enumerate(model.neck.lateral_convs):
        yield (f"neck__lateral_convs__{i}", "conv_dp", unit)
    head = model.bbox_head
    if head.multi_level_share_convs is not None:
        for lvl, units in enumerate(head.multi_level_share_convs):
            for j, unit in enumerate(units):
                yield (f"bbox_head__multi_level_share_convs__{lvl}__{j}",
                       "conv_dp", unit)
    for key in head.branches:
        for lvl, unit in enumerate(getattr(head, f"multi_level_{key}")):
            yield (f"bbox_head__multi_level_{key}__{lvl}", "conv_dp", unit)


@torch.no_grad()
def generate_cpp(model: nn.Module, cfg: ModelConfig) -> str:
    entries: List[Dict[str, Any]] = []
    for name, kind, m in walk_modules(model, cfg):
        if kind == "conv_head":
            w2, b2 = fold_conv_bn(m.conv1.weight, m.conv1.bias, m.bn1)
            entries.append(_serialize(w2, b2, name + "_pw",
                                      depthwise=False, with_bn=True,
                                      first3x3x3=True))
            _emit_conv_dp(entries, m.conv2, name + "_dp")
        elif kind == "conv4layer":
            _emit_conv_dp(entries, m.conv1, name + "_dp1")
            _emit_conv_dp(entries, m.conv2, name + "_dp2")
        elif kind == "conv_dp":
            _emit_conv_dp(entries, m, name)

    out = [HEADER]
    for d in entries:
        out.append(f"float {d['weight_name']}[{d['weight_size']}] = "
                   f"{{{d['weight']}}};\n")
        out.append(f"float {d['bias_name']}[{d['bias_size']}] = "
                   f"{{{d['bias']}}};\n")
    out.append("\n//(in_channels, out_channels, is_depthwise, is_pointwise,"
               " with_bn, weight_ptr, bias_ptr)\n")
    out.append(f"ConvInfoStruct param_pConvInfo[{len(entries)}] = {{\n")
    rows = []
    for d in entries:
        def cb(b):
            return "true" if b else "false"
        rows.append(
            f"\t{{{d['in_channels']}, {d['out_channels']}, "
            f"{cb(d['is_dw'])}, {cb(not d['is_dw'])}, {cb(d['with_bn'])}, "
            f"{d['weight_name']}, {d['bias_name']}}}")
    out.append(",\n".join(rows) + "\n};")
    return "".join(out)
