"""SCRFD (Guo et al., "Sample and Computation Redistribution for Efficient
Face Detection", ICLR 2022) for inference: a ResNetV1e backbone of
BasicBlocks, a PAFPN neck and an SCRFDHead with one BN tower a stride,
as insightface's ``detection/scrfd`` builds them for
``configs/scrfd/scrfd_10g_bnkps.py``.

Submodules carry the mmdet names of the published checkpoint
(``backbone.stem.0``, ``backbone.layer2.0.downsample.1``,
``neck.lateral_convs.0.conv``, ``bbox_head.cls_stride_convs.8.0.bn``,
``bbox_head.stride_reg.8``, ``bbox_head.scales.0.scale``, ...), so its
state dict loads as it is.

  * input: raw 0-255 BGR as YuNet takes it; the network turns it into
    RGB and (x - 127.5) / 128, insightface's input transform;
  * backbone: a deep stem (3x3/2 conv, two 3x3 convs, each conv -> BN ->
    ReLU) and a 2x2/2 max pool, then four stages of BasicBlocks
    (3x3 conv -> BN -> ReLU -> 3x3 conv -> BN, the shortcut added, then
    ReLU; the stride on the first conv). The shortcut of a stage's first
    block, where the stride or width changes, is avg-down: a 2x2/2
    average pool (ceil mode, padding not counted), a 1x1 conv and BN;
  * neck (PAFPN, convs with a bias and nothing after them): 1x1 laterals
    on the /8, /16 and /32 maps, a top-down pass of 2x nearest upsamples
    added, a 3x3 conv a level, a bottom-up pass of 3x3/2 convs added to
    the level above, and a 3x3 conv on the upper two levels;
  * head: a tower of 3x3 conv -> BN -> ReLU a stride, shared by the
    branches, then 3x3 output convs with a bias: cls (num_anchors
    logits), reg (4 distances an anchor, times a learned Scale a stride)
    and kps (2 * kps_num offsets an anchor).

Every conv runs in the input's dtype and BatchNorm in f32 (as YuNet's
``layers.py`` does). ``fold_scrfd`` folds BN and the Scale into the convs
for ``scrfd_forward``, the detect path's trunk: bf16 (or f32),
channels-last, every conv through ``scrfd_conv``, which counts them. A
conv takes its bias, the shortcut or FPN add it feeds and its ReLU in one
call (``ops/conv_epi.py``: in bf16 on the card, one kernel's epilogue).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SCRFDConfig
from ..ops.boxes import distance_decode, kps_decode
from ..ops.conv_epi import conv_epi, conv_epi_plain, pack_weights
from ..utils.profiling import span
from .fused import fold_conv_bn
from .head import flatten_level_outputs
from .layers import _bn, batch_norm_eval

INPUT_MEAN, INPUT_STD = 127.5, 128.0


def normalize_input(x: torch.Tensor) -> torch.Tensor:
    """(x - 127.5) / 128 in x's dtype: exact in bf16 for 0-255 integers
    (a half step below 128 needs 8 significant bits, bf16's count)."""
    return (x - INPUT_MEAN) * (1.0 / INPUT_STD)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=bias, device="meta")


def _run_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv in x's dtype, its weights cast to it."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, conv.stride,
                    conv.padding)


class ConvModule(nn.Module):
    """mmcv's ConvModule as SCRFD uses it: ``conv``, then ``bn`` and ReLU
    where it has a norm (its conv then has no bias), else the bare conv
    with a bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 with_bn: bool = False):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, bias=not with_bn)
        self.bn = _bn(cout) if with_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_conv(x, self.conv)
        return x if self.bn is None else F.relu(batch_norm_eval(x, self.bn))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            # avg-down: the pool takes the stride, the 1x1 conv the width
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride, ceil_mode=True,
                             count_include_pad=False),
                _conv(cin, planes, 1), _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(batch_norm_eval(_run_conv(x, self.conv1), self.bn1))
        y = batch_norm_eval(_run_conv(y, self.conv2), self.bn2)
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            x = batch_norm_eval(_run_conv(pool(x), conv), bn)
        return F.relu(y + x)


class ResNetV1e(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        c0, c1, c2 = cfg.stem_channels
        self.stem = nn.Sequential(
            _conv(3, c0, 3, 2), _bn(c0), nn.ReLU(),
            _conv(c0, c1, 3), _bn(c1), nn.ReLU(),
            _conv(c1, c2, 3), _bn(c2), nn.ReLU())
        cin = c2
        for i, (n, planes) in enumerate(zip(cfg.stage_blocks,
                                            cfg.stage_planes)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(cin, planes,
                                         2 if i > 0 and j == 0 else 1))
                cin = planes
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(cfg.stage_blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        for i in (0, 3, 6):
            x = F.relu(batch_norm_eval(_run_conv(x, self.stem[i]),
                                       self.stem[i + 1]))
        x = F.max_pool2d(x, 2)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


class PAFPN(nn.Module):
    def __init__(self, in_channels, out_channels: int):
        super().__init__()
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3) for _ in range(n))
        self.downsample_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, 2)
            for _ in range(n - 1))
        self.pafpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3) for _ in range(n - 1))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        lat = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode="nearest")
        inter = [conv(f) for conv, f in zip(self.fpn_convs, lat)]
        for i, conv in enumerate(self.downsample_convs):
            inter[i + 1] = inter[i + 1] + conv(inter[i])
        return [inter[0]] + [conv(f) for conv, f in
                             zip(self.pafpn_convs, inter[1:])]


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((), device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class SCRFDHead(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        a, fc = cfg.num_anchors, cfg.feat_channels
        keys = [str(s) for s in cfg.strides]
        self.cls_stride_convs = nn.ModuleDict({k: nn.ModuleList(
            ConvModule(cfg.neck_out_channels if i == 0 else fc, fc, 3,
                       with_bn=True)
            for i in range(cfg.stacked_convs)) for k in keys})
        self.stride_cls = nn.ModuleDict(
            {k: _conv(fc, cfg.num_classes * a, 3, bias=True) for k in keys})
        self.stride_reg = nn.ModuleDict(
            {k: _conv(fc, 4 * a, 3, bias=True) for k in keys})
        self.stride_kps = nn.ModuleDict(
            {k: _conv(fc, 2 * cfg.kps_num * a, 3, bias=True)
             for k in keys}) if cfg.use_kps else None
        self.scales = nn.ModuleList(Scale() for _ in keys)

    def forward(self, feats: List[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        out: Dict[str, List[torch.Tensor]] = {"cls": [], "bbox": [],
                                              "kps": []}
        for lvl, (key, f) in enumerate(zip(self.stride_cls, feats)):
            for m in self.cls_stride_convs[key]:
                f = m(f)
            out["cls"].append(_run_conv(f, self.stride_cls[key]))
            out["bbox"].append(self.scales[lvl](
                _run_conv(f, self.stride_reg[key])))
            if self.stride_kps is not None:
                out["kps"].append(_run_conv(f, self.stride_kps[key]))
        return {k: v for k, v in out.items() if v}


class SCRFD(nn.Module):
    def __init__(self, cfg: SCRFDConfig, *, device):
        """Built on ``device`` with zero weights and identity BN, for a
        model that is about to load a state dict."""
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetV1e(cfg)
        self.neck = PAFPN(cfg.stage_planes[cfg.neck_start_level:],
                          cfg.neck_out_channels)
        self.bbox_head = SCRFDHead(cfg)
        self.to_empty(device=device)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
                elif isinstance(m, (nn.Conv2d, Scale)):
                    for p in m.parameters():
                        p.zero_()
        self.eval()

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """x: (B, 3, H, W) raw BGR, H and W multiples of 32. Returns the
        per-level NCHW maps of cls, bbox (distances in strides) and
        kps."""
        with span("scrfd.backbone"):
            feats = self.backbone(normalize_input(x.flip(1)))
        with span("scrfd.neck"):
            feats = self.neck(feats[self.cfg.neck_start_level:])
        with span("scrfd.head"):
            return self.bbox_head(feats)

    def forward_flat(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return flatten_level_outputs(self.forward(x), self.cfg.num_anchors)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def fold(self, dtype: torch.dtype) -> Dict[str, object]:
        return fold_scrfd(self, dtype)

    @staticmethod
    def forward_folded(folded: Dict[str, object], x: torch.Tensor,
                       cfg: SCRFDConfig, *, use_kernel: bool
                       ) -> Dict[str, torch.Tensor]:
        return scrfd_forward(folded, x, cfg)      # no kernel of its own

    @staticmethod
    def decode(flat: Dict[str, torch.Tensor], priors: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (torch.sigmoid(flat["cls"][..., 0].float()),
                distance_decode(priors, flat["bbox"].float()),
                kps_decode(priors, flat["kps"].float()))

    @staticmethod
    def num_anchors(cfg: SCRFDConfig) -> int:
        return cfg.num_anchors


# -- the folded trunk -----------------------------------------------------------

@dataclass
class FoldedConv:
    """One conv with BN (and the reg branch's Scale) folded in: w OIHW
    channels-last in the trunk's dtype, for the plain version; wp the same
    weights packed once for the kernel (``ops/conv_epi.py:pack_weights``,
    bf16); b in f32; its stride and whether a ReLU ends it (after the
    shortcut's add, where the conv takes one)."""

    w: torch.Tensor
    wp: torch.Tensor
    b: torch.Tensor
    stride: int
    relu: bool


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d], dtype, *,
          relu: bool, scale: Optional[torch.Tensor] = None,
          w: Optional[torch.Tensor] = None) -> FoldedConv:
    w = conv.weight if w is None else w
    b = conv.bias if conv.bias is not None else torch.zeros(
        w.shape[0], device=w.device)
    if bn is not None:
        w, b = fold_conv_bn(w, b, bn)
    if scale is not None:
        w, b = w * scale, b * scale
    return FoldedConv(
        w=w.float().to(dtype).contiguous(memory_format=torch.channels_last),
        wp=pack_weights(w), b=b.float().contiguous(),
        stride=conv.stride[0], relu=relu)


@torch.no_grad()
def fold_scrfd(model: SCRFD, dtype: torch.dtype = torch.float32
               ) -> Dict[str, object]:
    """The tree ``scrfd_forward`` runs: every BN folded into its conv,
    each stride's Scale into its reg conv, and the input's BGR -> RGB
    swap into the first conv's input channels; weights cast to
    ``dtype``."""
    bb, neck, head = model.backbone, model.neck, model.bbox_head
    stem = bb.stem
    out: Dict[str, object] = {"stem": [
        _fold(stem[0], stem[1], dtype, relu=True,
              w=stem[0].weight.flip(1)),
        _fold(stem[3], stem[4], dtype, relu=True),
        _fold(stem[6], stem[7], dtype, relu=True)]}
    out["layers"] = [[{
        "conv1": _fold(blk.conv1, blk.bn1, dtype, relu=True),
        # the ReLU after the shortcut's add, in conv2's epilogue
        "conv2": _fold(blk.conv2, blk.bn2, dtype, relu=True),
        "down": None if blk.downsample is None else _fold(
            blk.downsample[1], blk.downsample[2], dtype, relu=False)}
        for blk in getattr(bb, f"layer{i + 1}")]
        for i in range(bb.num_stages)]
    out["neck"] = {k: [_fold(m.conv, None, dtype, relu=False)
                       for m in getattr(neck, f"{k}_convs")]
                   for k in ("lateral", "fpn", "downsample", "pafpn")}
    out["head"] = [{
        "tower": [_fold(m.conv, m.bn, dtype, relu=True)
                  for m in head.cls_stride_convs[key]],
        "cls": _fold(head.stride_cls[key], None, dtype, relu=False),
        "bbox": _fold(head.stride_reg[key], None, dtype, relu=False,
                      scale=head.scales[lvl].scale.float()),
        **({} if head.stride_kps is None else {
            "kps": _fold(head.stride_kps[key], None, dtype, relu=False)})}
        for lvl, key in enumerate(head.stride_cls)]
    return out


def scrfd_conv(x: torch.Tensor, c: FoldedConv,
               residual: Optional[torch.Tensor] = None,
               upsample: int = 1) -> torch.Tensor:
    """One folded conv (padding k // 2), + residual (at the output's
    resolution, or at 1 / upsample of it, repeated nearest), then its
    ReLU: the kernel of ``ops/conv_epi.py`` for bf16 on the card, the
    plain version otherwise. Counts itself in ``scrfd_conv.launches``,
    eagerly or into a CUDA graph's capture."""
    scrfd_conv.launches += 1
    kw = dict(stride=c.stride, relu=c.relu, residual=residual,
              upsample=upsample)
    if x.is_cuda and x.dtype == torch.bfloat16:
        return conv_epi(x, c.w, c.wp, c.b, **kw)
    return conv_epi_plain(x, c.w, c.b, **kw)


scrfd_conv.launches = 0


def scrfd_forward(folded: Dict[str, object], x: torch.Tensor,
                  cfg: SCRFDConfig) -> Dict[str, torch.Tensor]:
    """x: (N, 3, H, W) raw BGR in the folded weights' dtype (a
    channels-last view keeps the trunk channels-last) -> the flattened
    cls, bbox and kps of ``SCRFD.forward_flat``."""
    with span("scrfd.backbone"):
        y = normalize_input(x)
        for c in folded["stem"]:
            y = scrfd_conv(y, c)
        y = F.max_pool2d(y, 2)
        feats = []
        for stage in folded["layers"]:
            for blk in stage:
                short = y if blk["down"] is None else scrfd_conv(
                    F.avg_pool2d(y, 2, 2, ceil_mode=True,
                                 count_include_pad=False), blk["down"])
                y = scrfd_conv(scrfd_conv(y, blk["conv1"]), blk["conv2"],
                               residual=short)
            feats.append(y)
    with span("scrfd.neck"):
        neck = folded["neck"]
        # top-down: the coarsest lateral first, each finer one adding the
        # one above it, upsampled 2x, in its epilogue
        ins = feats[cfg.neck_start_level:]
        lat = [scrfd_conv(ins[-1], neck["lateral"][-1])]
        for f, c in zip(ins[-2::-1], neck["lateral"][-2::-1]):
            lat.insert(0, scrfd_conv(f, c, residual=lat[0], upsample=2))
        inter = [scrfd_conv(f, c) for c, f in zip(neck["fpn"], lat)]
        for i, c in enumerate(neck["downsample"]):
            inter[i + 1] = scrfd_conv(inter[i], c, residual=inter[i + 1])
        feats = [inter[0]] + [scrfd_conv(f, c) for c, f in
                              zip(neck["pafpn"], inter[1:])]
    with span("scrfd.head"):
        out: Dict[str, List[torch.Tensor]] = {}
        for d, f in zip(folded["head"], feats):
            for c in d["tower"]:
                f = scrfd_conv(f, c)
            for key in ("cls", "bbox", "kps"):
                if key in d:
                    out.setdefault(key, []).append(scrfd_conv(f, d[key]))
        return flatten_level_outputs(out, cfg.num_anchors)
