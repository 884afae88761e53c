"""The plain YuNet: its forward pass as functions of a state dict, in
float32, written from the reference (ShiqiYu/libfacedetection.train,
``mmdet/models/backbones/yunet_backbone.py``, ``necks/tfpn.py``,
``dense_heads/yunet_head.py``, ``utils/yunet_layer.py``) with the
configuration file's ``model`` group for its sizes.

A ConvDPUnit is a 1x1 conv with bias, a 3x3 depthwise conv with bias,
then BatchNorm and ReLU where it has them. The stem is a 3x3/2 conv, BN,
ReLU and one unit; each later stage two units; a 2x2 max pool follows the
stages in ``downsample_idx``. The TFPN adds each level, convolved by its
lateral unit, upsampled 2x nearest into the level below before that
level's own unit. The head has optional shared units a level, then
cls / bbox / obj / kps units without BN.

BatchNorm uses the running statistics (the model as it is served).
``precision="fp8"`` is the benchmark's control, the step below bf16 that
a change could be tempted to take: every conv's input and weight rounded
to float8 e4m3 with a per-tensor scale. ``"f32"`` is the reference
itself. Nothing here reads the program: the weights are the state dict
the benchmark loaded.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and matmuls while the reference
    runs; the flags as they were afterwards."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# -- the parameters ---------------------------------------------------------

def _unit_shapes(prefix: str, cin: int, cout: int, bn: bool):
    out = [(f"{prefix}.conv1.weight", (cout, cin, 1, 1)),
           (f"{prefix}.conv1.bias", (cout,)),
           (f"{prefix}.conv2.weight", (cout, 1, 3, 3)),
           (f"{prefix}.conv2.bias", (cout,))]
    if bn:
        out += _bn_shapes(f"{prefix}.bn", cout)
    return out


def _bn_shapes(prefix: str, c: int):
    return [(f"{prefix}.{k}", (c,)) for k in
            ("weight", "bias", "running_mean", "running_var")]


def _head_outs(m: dict) -> Dict[str, int]:
    outs = {"cls": m["num_classes"], "bbox": 4, "obj": 1}
    if m["use_kps"]:
        outs["kps"] = 2 * m["kps_num"]
    return outs


def param_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the model, under the reference
    checkpoint's names (BN running statistics included)."""
    st = m["stage_channels"]
    out = [("backbone.model0.conv1.weight", (st[0][1], st[0][0], 3, 3)),
           ("backbone.model0.conv1.bias", (st[0][1],))]
    out += _bn_shapes("backbone.model0.bn1", st[0][1])
    out += _unit_shapes("backbone.model0.conv2", st[0][1], st[0][2], True)
    for i in range(1, len(st)):
        cin, cout = st[i]
        out += _unit_shapes(f"backbone.model{i}.conv1", cin, cin, True)
        out += _unit_shapes(f"backbone.model{i}.conv2", cin, cout, True)
    for i, c in enumerate(m["neck_in_channels"]):
        out += _unit_shapes(f"neck.lateral_convs.{i}", c, c, True)
    levels = len(m["strides"])
    chn = m["head_in_channels"]
    for lvl in range(levels):
        for j in range(m["shared_stacked_convs"]):
            out += _unit_shapes(
                f"bbox_head.multi_level_share_convs.{lvl}.{j}",
                chn if j == 0 else m["feat_channels"], m["feat_channels"],
                True)
    if m["shared_stacked_convs"] > 0:
        chn = m["feat_channels"]
    for b, oc in _head_outs(m).items():
        for lvl in range(levels):
            out += _unit_shapes(f"bbox_head.multi_level_{b}.{lvl}", chn, oc,
                                False)
    return out


# -- the forward pass ---------------------------------------------------------

def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with a per-tensor scale (largest |t| to
    448)."""
    scale = 448.0 / torch.clamp(t.abs().max(), min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Forward:
    """One forward pass over a state dict, BN with its running
    statistics."""

    def __init__(self, m: dict, sd: Dict[str, torch.Tensor], *,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision}: f32 or fp8")
        self.m, self.sd = m, sd
        self.q = fake_fp8 if precision == "fp8" else (lambda t: t)

    def conv(self, x, name, **kw):
        return F.conv2d(self.q(x), self.q(self.sd[name + ".weight"]),
                        self.sd[name + ".bias"], **kw)

    def bn(self, x, name):
        sd = self.sd
        w, b = sd[name + ".weight"], sd[name + ".bias"]
        mean, var = sd[name + ".running_mean"], sd[name + ".running_var"]
        inv = torch.rsqrt(var + BN_EPS) * w
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + b[None, :, None, None]

    def unit(self, x, name, bn=True):
        x = self.conv(x, name + ".conv1")
        x = self.conv(x, name + ".conv2", padding=1, groups=x.shape[1])
        return F.relu(self.bn(x, name + ".bn")) if bn else x

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) f32 raw BGR -> {branch: (B, P, C)} in the
        priors' order (level by level, rows then columns)."""
        m = self.m
        x = self.conv(x, "backbone.model0.conv1", stride=2, padding=1)
        x = F.relu(self.bn(x, "backbone.model0.bn1"))
        x = self.unit(x, "backbone.model0.conv2")
        feats = []
        for i in range(len(m["stage_channels"])):
            if i > 0:
                x = self.unit(x, f"backbone.model{i}.conv1")
                x = self.unit(x, f"backbone.model{i}.conv2")
            if i in m["out_idx"]:
                feats.append(x)
            if i in m["downsample_idx"]:
                x = F.max_pool2d(x, 2)
        for i in range(len(feats) - 1, 0, -1):
            feats[i] = self.unit(feats[i], f"neck.lateral_convs.{i}")
            feats[i - 1] = feats[i - 1] + F.interpolate(
                feats[i], scale_factor=2.0, mode="nearest")
        feats[0] = self.unit(feats[0], "neck.lateral_convs.0")
        out: Dict[str, List[torch.Tensor]] = {b: [] for b in _head_outs(m)}
        for lvl, f in enumerate(feats):
            for j in range(m["shared_stacked_convs"]):
                f = self.unit(f, f"bbox_head.multi_level_share_convs."
                                 f"{lvl}.{j}")
            for b in out:
                y = self.unit(f, f"bbox_head.multi_level_{b}.{lvl}",
                              bn=False)
                out[b].append(y.permute(0, 2, 3, 1).reshape(
                    y.shape[0], -1, y.shape[1]))
        return {b: torch.cat(v, dim=1) for b, v in out.items()}


def priors(m: dict, h: int, w: int, device) -> torch.Tensor:
    """(P, 4) [x, y, stride, stride]: x = (col + prior_offset) * stride,
    level by level, rows then columns."""
    out = []
    for s in m["strides"]:
        ys, xs = torch.meshgrid(
            (torch.arange(h // s, dtype=torch.float32) + m["prior_offset"])
            * s,
            (torch.arange(w // s, dtype=torch.float32) + m["prior_offset"])
            * s, indexing="ij")
        sw = torch.full_like(xs, float(s))
        out.append(torch.stack([xs, ys, sw, sw], -1).reshape(-1, 4))
    return torch.cat(out).to(device)


def decode(pri: torch.Tensor, bbox: torch.Tensor,
           kps: Optional[torch.Tensor]):
    """Boxes xyxy: centre = pred_xy * stride + prior, size =
    exp(pred_wh) * stride; keypoints = pred * stride + prior."""
    c = bbox[..., :2] * pri[..., 2:] + pri[..., :2]
    wh = torch.exp(bbox[..., 2:]) * pri[..., 2:]
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    if kps is None:
        return boxes, None
    pts = kps.reshape(*kps.shape[:-1], -1, 2) * pri[..., None, 2:] \
        + pri[..., None, :2]
    return boxes, pts.reshape(kps.shape)
