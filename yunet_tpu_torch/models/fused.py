"""Fused inference forward: BN folded into the depthwise convs, every
ConvDPUnit run by the fused pw->dw->ReLU kernel (ops/convdp.py) —
counterpart of ``yunet_tpu/models/fused.py:23-71, 124-195`` and
``fold_conv_bn`` (``yunet_tpu/export/cpp_export.py:33-43``).

Equal to ``YuNet.forward`` with running BN statistics, up to f32 rounding.
The stem conv, the max pools and the upsample stay library ops, as they
are in JAX. Activations run NHWC between the units (the kernel's layout);
the public functions take and return NCHW like the model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.convdp import fused_conv_dp
from .layers import ConvDPUnit, library_conv2d

if TYPE_CHECKING:
    from .detector import YuNet


@torch.no_grad()
def fold_conv_bn(w: torch.Tensor, b: torch.Tensor,
                 bn: torch.nn.BatchNorm2d):
    """Fold BN into a conv. w: OIHW; returns f32 (w', b') with
    conv(x, w') + b' == bn(conv(x, w) + b)."""
    # the square root in f64, rounded once to f32: the correctly rounded
    # f32 sqrt the JAX fold gets from numpy (torch's vectorized CPU sqrt
    # can be 1 ulp off)
    std = torch.sqrt((bn.running_var.float() + bn.eps).double()).float()
    scale = bn.weight.float() / std
    w2 = w.float() * scale[:, None, None, None]
    b2 = (b.float() - bn.running_mean.float()) * scale + bn.bias.float()
    return w2, b2


@dataclass
class FoldedUnit:
    """One ConvDPUnit with BN folded, in the kernel's layout:
    w1 (Cin, Cout), b1 (Cout,), wd (9, Cout) tap-major, bd (Cout,), f32."""

    w1: torch.Tensor
    b1: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor
    relu: bool
    _conv_weights: Dict[torch.dtype, tuple] = field(default_factory=dict,
                                                    repr=False)

    def conv_weights(self, dtype: torch.dtype):
        """(w1 OIHW, b1, wd OIHW, bd) cast to ``dtype``, for the library
        convs; cached per dtype."""
        if dtype not in self._conv_weights:
            cin, cout = self.w1.shape
            self._conv_weights[dtype] = tuple(t.to(dtype) for t in (
                self.w1.t().reshape(cout, cin, 1, 1), self.b1,
                self.wd.t().reshape(cout, 1, 3, 3), self.bd))
        return self._conv_weights[dtype]


@torch.no_grad()
def _fold_unit(unit: ConvDPUnit) -> FoldedUnit:
    cout, cin = unit.conv1.weight.shape[:2]
    wd, bd = unit.conv2.weight, unit.conv2.bias
    if unit.bn is not None:
        wd, bd = fold_conv_bn(wd, bd, unit.bn)
    # copies: the folded tree does not alias (or track) the model's weights
    return FoldedUnit(
        w1=unit.conv1.weight.reshape(cout, cin).t().float().clone(
            memory_format=torch.contiguous_format),
        b1=unit.conv1.bias.detach().float().clone(),
        wd=wd.reshape(cout, 9).t().float().clone(
            memory_format=torch.contiguous_format),
        bd=bd.detach().float().clone(), relu=unit.bn is not None)


@torch.no_grad()
def fold_inference_params(model: YuNet, cfg: ModelConfig) -> Dict[str, Any]:
    """Fold BN into conv weights across the whole model; returns a tree
    of folded units mirroring the model topology (fused.py:33-71)."""
    bb = model.backbone
    out: Dict[str, Any] = {"backbone": {}, "neck": {}, "head": {}}
    w, b = fold_conv_bn(bb.model0.conv1.weight, bb.model0.conv1.bias,
                        bb.model0.bn1)
    out["backbone"]["stem_conv"] = {"w": w, "b": b}
    out["backbone"]["stem_dp"] = _fold_unit(bb.model0.conv2)
    for i in range(1, len(cfg.stage_channels)):
        m = getattr(bb, f"model{i}")
        out["backbone"][f"m{i}a"] = _fold_unit(m.conv1)
        out["backbone"][f"m{i}b"] = _fold_unit(m.conv2)
    for i, unit in enumerate(model.neck.lateral_convs):
        out["neck"][str(i)] = _fold_unit(unit)
    head = model.bbox_head
    for lvl in range(len(cfg.strides)):
        d: Dict[str, Any] = {}
        if head.multi_level_share_convs is not None:
            d["share"] = [_fold_unit(u)
                          for u in head.multi_level_share_convs[lvl]]
        for key in head.branches:
            d[key] = _fold_unit(getattr(head, f"multi_level_{key}")[lvl])
        out["head"][str(lvl)] = d
    return out


def _unit(u: FoldedUnit, y: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """y: (N, H, W, C) -> (N, H, W, Cout)."""
    if use_kernel:
        return fused_conv_dp(y.contiguous(), u.w1, u.b1, u.wd, u.bd,
                             relu=u.relu)
    w1, b1, wd, bd = u.conv_weights(y.dtype)
    z = F.conv2d(y.permute(0, 3, 1, 2), w1, b1)
    z = library_conv2d(z, wd, bd, padding=1, groups=wd.shape[0])
    if u.relu:
        z = F.relu(z)
    return z.permute(0, 2, 3, 1)


def _max_pool2x(y: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _upsample2x(y: torch.Tensor) -> torch.Tensor:
    n, h, w, c = y.shape
    return y[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def fused_forward(folded: Dict[str, Any], x: torch.Tensor,
                  cfg: ModelConfig, *, use_kernel: bool = True
                  ) -> Dict[str, List[torch.Tensor]]:
    """x: (N, 3, H, W) raw BGR. Returns per-level NCHW maps per branch.

    use_kernel: True runs every ConvDPUnit through ``fused_conv_dp``
    (the CUDA kernel on the card, its plain version on the CPU); False
    runs the folded pair through the library convs in x's dtype, as the
    JAX serving program does at batch (fused.py:162-170)."""
    bb = folded["backbone"]
    stem = bb["stem_conv"]
    y = F.relu(F.conv2d(x, stem["w"].to(x.dtype), stem["b"].to(x.dtype),
                        stride=2, padding=1)).permute(0, 2, 3, 1)
    y = _unit(bb["stem_dp"], y, use_kernel)
    feats: List[torch.Tensor] = []
    for i in range(len(cfg.stage_channels)):
        if i > 0:
            y = _unit(bb[f"m{i}a"], y, use_kernel)
            y = _unit(bb[f"m{i}b"], y, use_kernel)
        if i in cfg.out_idx:
            feats.append(y)
        if i in cfg.downsample_idx:
            y = _max_pool2x(y)
    for i in range(len(feats) - 1, 0, -1):
        feats[i] = _unit(folded["neck"][str(i)], feats[i], use_kernel)
        feats[i - 1] = feats[i - 1] + _upsample2x(feats[i])
    feats[0] = _unit(folded["neck"]["0"], feats[0], use_kernel)

    outs: Dict[str, List[torch.Tensor]] = {}
    for lvl, f in enumerate(feats):
        d = folded["head"][str(lvl)]
        for u in d.get("share", []):
            f = _unit(u, f, use_kernel)
        for key, u in d.items():
            if key != "share":
                outs.setdefault(key, []).append(
                    _unit(u, f, use_kernel).permute(0, 3, 1, 2))
    return outs
