"""Import YuNet weights from an ONNX file (the reference's exports or the
exporter's) — counterpart of ``yunet_tpu/export/onnx_import.py``.

The exported graphs are BN-folded, so the weights map onto the *folded*
inference tree (``models/fused.py:fold_inference_params``) and drive a
fused Detector directly, with no ``.pth``.

Both emission orders are handled: the reference's torch trace emits the
head branch by branch (share x3, cls x3, bbox x3, obj x3, kps x3 —
yunet_head.py:185-225), export_onnx level by level; the out-channel
signature of the conv sequence tells them apart.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.fused import FoldedUnit
from .onnx_reader import read_onnx


def load_onnx_params(path: str, cfg: ModelConfig, *,
                     device) -> Dict[str, Any]:
    """The folded tree of ``fold_inference_params``' topology on
    ``device``: FoldedUnits (w1 (Cin, Cout), wd (9, Cout) tap-major, f32)
    and the stem conv OIHW."""
    g = read_onnx(path)
    device = torch.device(device)

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(
            device)

    def conv(node):
        return (g.initializers[node.inputs[1]],         # OIHW
                g.initializers[node.inputs[2]])

    convs = [n for n in g.nodes if n.op_type == "Conv"]
    # unit segmentation: first conv is the stem 3x3; then (pw, dw) pairs
    stem = convs[0]
    pairs = [(convs[i], convs[i + 1]) for i in range(1, len(convs), 2)]

    def unit(pw, dw, relu):
        w1, b1 = conv(pw)
        wd, bd = conv(dw)
        if w1.shape[2:] != (1, 1) or wd.shape[1:] != (1, 3, 3):
            raise ValueError(f"{path}: expected a pointwise and a depthwise "
                             f"3x3 conv, got {w1.shape} and {wd.shape}")
        cout, cin = w1.shape[:2]
        return FoldedUnit(w1=tensor(w1.reshape(cout, cin).T),
                          b1=tensor(b1), wd=tensor(wd.reshape(cout, 9).T),
                          bd=tensor(bd), relu=relu)

    out: Dict[str, Any] = {"backbone": {}, "neck": {}, "head": {}}
    w, b = conv(stem)
    out["backbone"]["stem_conv"] = {"w": tensor(w), "b": tensor(b)}

    i = 0
    out["backbone"]["stem_dp"] = unit(*pairs[i], True); i += 1
    for s in range(1, len(cfg.stage_channels)):
        out["backbone"][f"m{s}a"] = unit(*pairs[i], True); i += 1
        out["backbone"][f"m{s}b"] = unit(*pairs[i], True); i += 1
    # neck emission order is top-down (lateral 2, 1, 0) in both exporters
    nl = len(cfg.strides)
    for lvl in range(nl - 1, -1, -1):
        out["neck"][str(lvl)] = unit(*pairs[i], True); i += 1
    # fold_inference_params' key order
    out["neck"] = {str(lvl): out["neck"][str(lvl)] for lvl in range(nl)}

    head_pairs = pairs[i:]
    couts = [g.initializers[p[0].inputs[1]].shape[0] for p in head_pairs]
    shares = cfg.shared_stacked_convs
    keys = ["cls", "bbox", "obj", "kps"]
    branch_ch = [cfg.num_classes, 4, 1, cfg.kps_num * 2]
    ref_sig = ([cfg.feat_channels] * shares * nl
               + sum(([c] * nl for c in branch_ch), []))
    ours_sig = sum(([cfg.feat_channels] * shares + branch_ch
                    for _ in range(nl)), [])
    lvl_d: Dict[str, Dict] = {str(lvl): {} for lvl in range(nl)}
    k = 0
    if couts == ref_sig:
        # torch trace order: all shares (level-major), then branch-major
        for lvl in range(nl):
            if shares:
                lvl_d[str(lvl)]["share"] = [unit(*head_pairs[k + j], True)
                                            for j in range(shares)]
                k += shares
        for key in keys:
            for lvl in range(nl):
                lvl_d[str(lvl)][key] = unit(*head_pairs[k], False)
                k += 1
    elif couts == ours_sig:
        for lvl in range(nl):
            if shares:
                lvl_d[str(lvl)]["share"] = [unit(*head_pairs[k + j], True)
                                            for j in range(shares)]
                k += shares
            for key in keys:
                lvl_d[str(lvl)][key] = unit(*head_pairs[k], False)
                k += 1
    else:
        raise ValueError(
            f"unrecognized head conv layout: out channels {couts}")
    out["head"] = lvl_d
    return out
