"""RetinaFace (Deng et al., "RetinaFace: Single-stage Dense Face
Localisation in the Wild", CVPR 2020) with a ResNet-50 backbone, for
inference, as biubug6's Pytorch_Retinaface builds ``cfg_re50``
(``models/retinaface.py``, ``models/net.py``: ``FPN``, ``SSH``).

Submodules carry that checkpoint's names (``body.conv1``,
``body.layer2.0.downsample.1``, ``fpn.output1.0``, ``fpn.merge1.1``,
``ssh1.conv3X3.0``, ``ssh1.conv5X5_1.1``, ``ssh3.conv7x7_3.0``,
``ClassHead.0.conv1x1``, ``BboxHead.2.conv1x1``,
``LandmarkHead.1.conv1x1``), so its state dict loads as it is; the
``module.`` prefix its training leaves is stripped on load.

  * input: raw 0-255 BGR minus (104, 117, 123), no scale and no channel
    swap: integers in [-123, 151], exact in bf16;
  * backbone: torchvision's ResNet-50 (v1.5) without its pool and fc: a
    7x7/2 conv, BN, ReLU and a 3x3/2 max pool (padding 1), then four
    stages of Bottlenecks (1x1 conv, BN, ReLU; 3x3 conv with the stage's
    stride, BN, ReLU; 1x1 conv to 4 x planes, BN; the shortcut added, then
    ReLU), a stage's first shortcut a strided 1x1 conv and BN;
  * FPN on stages 2-4 (256 channels out; every "LeakyReLU" of net.py has
    slope 0 at that width, a ReLU): 1x1 conv, BN, ReLU laterals; the
    coarser level nearest-upsampled and added after the finer lateral's
    ReLU, then a 3x3 conv, BN, ReLU merge (none on the coarsest level);
  * SSH a level: a 3x3 conv and BN to half the channels; a 3x3 conv, BN,
    ReLU to a quarter, then a 3x3 conv and BN; from that quarter, a 3x3
    conv, BN, ReLU, then a 3x3 conv and BN; the three concatenated, then
    ReLU;
  * heads: 1x1 convs with a bias a level, class (2 logits an anchor), box
    (4) and landmarks (10), flattened location-major, anchor-minor.

Every conv runs in the input's dtype and BatchNorm in f32 (as YuNet's
``layers.py`` does). ``fold_retinaface`` folds every BN into its conv and
a level's three heads into one 256 -> 32 conv for ``retinaface_forward``,
the detect path's trunk: bf16 (or f32), channels-last, every conv through
``retinaface_conv``, which counts them. A conv takes its bias, the
shortcut it feeds (after its ReLU, for the FPN's laterals) and its ReLU
in one call of ``ops/conv_epi.py``, and an SSH branch's last conv and a
head write their part of the level's map, or of the heads' rows, in
place: no add, ReLU or concatenation runs outside the convs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RetinaFaceConfig
from ..ops.boxes import softmax_score, ssd_box_decode, ssd_kps_decode
from ..ops.conv_epi import conv_epi, conv_epi_plain, pack_weights
from ..utils.profiling import span
from .head import flatten_level_outputs
from .layers import _bn, batch_norm_eval
from .scrfd import FoldedConv, _conv, _fold, _run_conv

PREFIX = "module."         # what DataParallel training leaves on the names


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1
             ) -> nn.Sequential:
    """net.py's conv_bn, conv_bn1X1 and conv_bn_no_relu: ``0`` the conv
    (no bias), ``1`` its BN; the ReLU, where there is one, is applied by
    the caller."""
    return nn.Sequential(_conv(cin, cout, k, stride), _bn(cout))


def _cbr(x: torch.Tensor, m: nn.Sequential, relu: bool) -> torch.Tensor:
    y = batch_norm_eval(_run_conv(x, m[0]), m[1])
    return F.relu(y) if relu else y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, expansion: int):
        super().__init__()
        cout = planes * expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = _bn(cout)
        self.downsample = (_conv_bn(cin, cout, 1, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(batch_norm_eval(_run_conv(x, self.conv1), self.bn1))
        y = F.relu(batch_norm_eval(_run_conv(y, self.conv2), self.bn2))
        y = batch_norm_eval(_run_conv(y, self.conv3), self.bn3)
        if self.downsample is not None:
            x = _cbr(x, self.downsample, relu=False)
        return F.relu(y + x)


class ResNet50(nn.Module):
    def __init__(self, cfg: RetinaFaceConfig):
        super().__init__()
        c = cfg.stem_channels
        self.conv1 = _conv(3, c, 7, 2)
        self.bn1 = _bn(c)
        cin = c
        for i, (n, planes) in enumerate(zip(cfg.stage_blocks,
                                            cfg.stage_planes)):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, planes,
                                         2 if i > 0 and j == 0 else 1,
                                         cfg.expansion))
                cin = planes * cfg.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(cfg.stage_blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(batch_norm_eval(_run_conv(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"output{i + 1}", _conv_bn(c, out_channels, 1))
        for i in range(len(in_channels) - 1):
            self.add_module(f"merge{i + 1}",
                            _conv_bn(out_channels, out_channels, 3))
        self.levels = len(in_channels)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = [_cbr(f, getattr(self, f"output{i + 1}"), relu=True)
                for i, f in enumerate(feats)]
        for i in range(self.levels - 2, -1, -1):
            up = F.interpolate(outs[i + 1], size=outs[i].shape[2:],
                               mode="nearest")
            outs[i] = _cbr(outs[i] + up, getattr(self, f"merge{i + 1}"),
                           relu=True)
        return outs


class SSH(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv3X3 = _conv_bn(cin, cout // 2, 3)
        self.conv5X5_1 = _conv_bn(cin, cout // 4, 3)
        self.conv5X5_2 = _conv_bn(cout // 4, cout // 4, 3)
        self.conv7X7_2 = _conv_bn(cout // 4, cout // 4, 3)
        self.conv7x7_3 = _conv_bn(cout // 4, cout // 4, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = _cbr(x, self.conv3X3, relu=False)
        t = _cbr(x, self.conv5X5_1, relu=True)
        b = _cbr(t, self.conv5X5_2, relu=False)
        u = _cbr(t, self.conv7X7_2, relu=True)
        c = _cbr(u, self.conv7x7_3, relu=False)
        return F.relu(torch.cat([a, b, c], dim=1))


class Head(nn.Module):
    """net.py's ClassHead, BboxHead and LandmarkHead: one 1x1 conv with a
    bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = _conv(cin, cout, 1, bias=True)


HEADS = (("ClassHead", "cls", 2), ("BboxHead", "bbox", 4),
         ("LandmarkHead", "kps", None))      # None: 2 * kps_num


def head_outs(cfg: RetinaFaceConfig) -> Dict[str, int]:
    """The channels an anchor of each head, by its flat output's key."""
    return {key: c or 2 * cfg.kps_num for _, key, c in HEADS}


class RetinaFace(nn.Module):
    def __init__(self, cfg: RetinaFaceConfig, *, device):
        """Built on ``device`` with zero weights and identity BN, for a
        model that is about to load a state dict."""
        super().__init__()
        self.cfg = cfg
        self.body = ResNet50(cfg)
        widths = [p * cfg.expansion for p in
                  cfg.stage_planes[cfg.neck_start_level:]]
        c = cfg.out_channel
        self.fpn = FPN(widths, c)
        for i in range(len(widths)):
            self.add_module(f"ssh{i + 1}", SSH(c, c))
        outs = head_outs(cfg)
        for name, key, _ in HEADS:
            self.add_module(name, nn.ModuleList(
                Head(c, cfg.num_anchors * outs[key]) for _ in widths))
        self.levels = len(widths)
        self.to_empty(device=device)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
                elif isinstance(m, nn.Conv2d):
                    for p in m.parameters():
                        p.zero_()
        self.eval()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """The state dict under biubug6's names, with or without the
        ``module.`` prefix of a DataParallel checkpoint."""
        sd = {k[len(PREFIX):] if k.startswith(PREFIX) else k: v
              for k, v in state_dict.items()}
        return super().load_state_dict(sd, strict=strict, assign=assign)

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """x: (B, 3, H, W) raw BGR. Returns the per-level NCHW maps of the
        class logits, box offsets and landmark offsets."""
        cfg = self.cfg
        with span("retinaface.backbone"):
            mean = torch.tensor(cfg.input_mean, dtype=x.dtype,
                                device=x.device)
            feats = self.body(x - mean[:, None, None])
        with span("retinaface.fpn"):
            feats = self.fpn(feats[cfg.neck_start_level:])
        with span("retinaface.ssh"):
            feats = [getattr(self, f"ssh{i + 1}")(f)
                     for i, f in enumerate(feats)]
        with span("retinaface.head"):
            return {key: [_run_conv(f, h.conv1x1)
                          for h, f in zip(getattr(self, name), feats)]
                    for name, key, _ in HEADS}

    def forward_flat(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return flatten_level_outputs(self.forward(x), self.cfg.num_anchors)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def fold(self, dtype: torch.dtype) -> Dict[str, object]:
        return fold_retinaface(self, dtype)

    @staticmethod
    def forward_folded(folded: Dict[str, object], x: torch.Tensor,
                       cfg: RetinaFaceConfig, *, use_kernel: bool
                       ) -> Dict[str, torch.Tensor]:
        return retinaface_forward(folded, x, cfg, use_kernel=use_kernel)

    @staticmethod
    def decode(flat: Dict[str, torch.Tensor], priors: torch.Tensor,
               cfg: RetinaFaceConfig):
        v = cfg.variance
        return (softmax_score(flat["cls"].float()),
                ssd_box_decode(priors, flat["bbox"].float(), v),
                ssd_kps_decode(priors, flat["kps"].float(), v[0]))

    @staticmethod
    def num_anchors(cfg: RetinaFaceConfig) -> int:
        return cfg.num_anchors

    @staticmethod
    def priors(cfg: RetinaFaceConfig, h: int, w: int) -> np.ndarray:
        """(P, 4) f32 [cx, cy, m, m] in pixels: at level k (step s, a map
        of ceil(h / s) x ceil(w / s)), location (i, j) and each size m of
        ``min_sizes[k]``, cx = (j + 0.5) s and cy = (i + 0.5) s;
        location-major, anchor-minor, level by level
        (``layers/functions/prior_box.py``)."""
        levels = []
        for s, sizes in zip(cfg.steps, cfg.min_sizes):
            fh, fw = -(-h // s), -(-w // s)
            cx, cy = np.meshgrid((np.arange(fw) + 0.5) * s,
                                 (np.arange(fh) + 0.5) * s)
            m = np.asarray(sizes, np.float64)
            grid = np.stack(np.broadcast_arrays(
                cx.reshape(-1, 1), cy.reshape(-1, 1), m, m), -1)
            levels.append(grid.reshape(-1, 4))
        return np.concatenate(levels).astype(np.float32)

    @staticmethod
    def count_macs(cfg: RetinaFaceConfig, input_size) -> int:
        from ..utils.flops import retinaface_macs
        return retinaface_macs(cfg, input_size)


# -- the folded trunk ---------------------------------------------------------

@torch.no_grad()
def fold_retinaface(model: RetinaFace, dtype: torch.dtype = torch.float32
                    ) -> Dict[str, object]:
    """The tree ``retinaface_forward`` runs: every BN folded into its conv,
    a level's class, box and landmark heads into one conv (their channels
    in that order), the input mean as a (1, 3, 1, 1) tensor; weights cast
    to ``dtype``. An SSH branch's last conv carries the SSH's ReLU."""
    body, fpn = model.body, model.fpn
    cl = torch.channels_last

    def seq(m: nn.Sequential, relu: bool) -> FoldedConv:
        return _fold(m[0], m[1], dtype, relu=relu)

    out: Dict[str, object] = {
        "mean": torch.tensor(model.cfg.input_mean, dtype=dtype,
                             device=body.conv1.weight.device
                             ).view(1, 3, 1, 1),
        "stem": _fold(body.conv1, body.bn1, dtype, relu=True)}
    out["layers"] = [[{
        "conv1": _fold(blk.conv1, blk.bn1, dtype, relu=True),
        "conv2": _fold(blk.conv2, blk.bn2, dtype, relu=True),
        # the ReLU after the shortcut's add, in conv3's epilogue
        "conv3": _fold(blk.conv3, blk.bn3, dtype, relu=True),
        "down": None if blk.downsample is None
        else seq(blk.downsample, relu=False)}
        for blk in getattr(body, f"layer{i + 1}")]
        for i in range(body.num_stages)]
    out["fpn"] = {
        "output": [seq(getattr(fpn, f"output{i + 1}"), relu=True)
                   for i in range(fpn.levels)],
        "merge": [seq(getattr(fpn, f"merge{i + 1}"), relu=True)
                  for i in range(fpn.levels - 1)]}
    out["ssh"] = [{
        "a": seq(s.conv3X3, relu=True), "t": seq(s.conv5X5_1, relu=True),
        "b": seq(s.conv5X5_2, relu=True), "u": seq(s.conv7X7_2, relu=True),
        "c": seq(s.conv7x7_3, relu=True)}
        for s in (getattr(model, f"ssh{i + 1}")
                  for i in range(model.levels))]
    heads = []
    for lvl in range(model.levels):
        convs = [getattr(model, name)[lvl].conv1x1 for name, _, _ in HEADS]
        w = torch.cat([c.weight for c in convs]).float()
        b = torch.cat([c.bias for c in convs]).float()
        heads.append(FoldedConv(
            w=w.to(dtype).contiguous(memory_format=cl), wp=pack_weights(w),
            b=b.contiguous(), stride=1, relu=False))
    out["head"] = heads
    return out


def retinaface_conv(x: torch.Tensor, c: FoldedConv,
                    residual=None, upsample: int = 1, *,
                    post_add: bool = False, out=None,
                    use_kernel: bool = True) -> torch.Tensor:
    """One folded conv (padding k // 2), its bias, the residual (at the
    output's resolution, or at 1 / upsample of it, repeated nearest) added
    before its ReLU or, with post_add, after it; into ``out`` where given:
    the kernel of ``ops/conv_epi.py`` for bf16 on the card where
    ``use_kernel``, the plain version otherwise. Counts itself in
    ``retinaface_conv.launches``, eagerly or into a CUDA graph's
    capture."""
    retinaface_conv.launches += 1
    kw = dict(stride=c.stride, relu=c.relu, residual=residual,
              upsample=upsample, post_add=post_add, out=out)
    if use_kernel and x.is_cuda and x.dtype == torch.bfloat16:
        return conv_epi(x, c.w, c.wp, c.b, **kw)
    return conv_epi_plain(x, c.w, c.b, **kw)


retinaface_conv.launches = 0


def retinaface_forward(folded: Dict[str, object], x: torch.Tensor,
                       cfg: RetinaFaceConfig, *, use_kernel: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """x: (N, 3, H, W) raw BGR in the folded weights' dtype, H and W
    multiples of 32 (a channels-last view keeps the trunk channels-last)
    -> the flattened cls, bbox and kps of ``RetinaFace.forward_flat``."""
    def conv(y, c, *args, **kw):
        return retinaface_conv(y, c, *args, use_kernel=use_kernel, **kw)

    cl = torch.channels_last
    with span("retinaface.backbone"):
        y = conv(x - folded["mean"], folded["stem"])
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for stage in folded["layers"]:
            for blk in stage:
                short = y if blk["down"] is None else conv(y, blk["down"])
                y = conv(conv(conv(y, blk["conv1"]), blk["conv2"]),
                         blk["conv3"], short)
            feats.append(y)
    with span("retinaface.fpn"):
        # the coarsest lateral first; each finer one adds the merged level
        # above it, upsampled 2x, after its ReLU, in its epilogue
        fpn = folded["fpn"]
        ins = feats[cfg.neck_start_level:]
        levels = [conv(ins[-1], fpn["output"][-1])]
        for f, c, m in zip(ins[-2::-1], fpn["output"][-2::-1],
                           fpn["merge"][::-1]):
            levels.insert(0, conv(conv(f, c, levels[0], 2, post_add=True),
                                  m))
    with span("retinaface.ssh"):
        # each branch's last conv writes its channels of the level's map,
        # ReLU applied: relu(cat) = cat(relu)
        half, quarter = cfg.out_channel // 2, cfg.out_channel // 4
        maps = []
        for f, s in zip(levels, folded["ssh"]):
            m = torch.empty((f.shape[0], cfg.out_channel, *f.shape[2:]),
                            dtype=f.dtype, device=f.device,
                            memory_format=cl)
            conv(f, s["a"], out=m[:, :half])
            t = conv(f, s["t"])
            conv(t, s["b"], out=m[:, half:half + quarter])
            conv(conv(t, s["u"]), s["c"], out=m[:, half + quarter:])
            maps.append(m)
    with span("retinaface.head"):
        # each level's merged head writes its run of locations of one
        # (N, locations, 32) map: the flat order, with no concatenation
        n, outs = x.shape[0], head_outs(cfg)
        rows = torch.empty((n, sum(m.shape[2] * m.shape[3] for m in maps),
                            sum(outs.values()) * cfg.num_anchors),
                           dtype=x.dtype, device=x.device)
        at = 0
        for m, c in zip(maps, folded["head"]):
            h, w = m.shape[2:]
            conv(m, c, out=rows[:, at:at + h * w].unflatten(
                1, (h, w)).permute(0, 3, 1, 2))
            at += h * w
        flat, ch = {}, 0
        for key, per in outs.items():
            width = per * cfg.num_anchors
            flat[key] = rows[..., ch:ch + width].reshape(n, -1, per)
            ch += width
        return flat
