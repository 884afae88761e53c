"""Analytic complexity counter (params + multiply-accumulates) — a copy of
``yunet_tpu/utils/flops.py`` (framework-neutral; a test holds the counts
equal to the original's), and the port's own count for an SCRFD plan
(``scrfd_convs``, ``scrfd_macs``).

Replaces tools/get_flops.py + mmcv get_model_complexity_info: the model is
a fixed conv pipeline, so MACs are computed in closed form from the
architecture plan. The mmcv convention reported in the reference README
("MFLOPs" 149/96 @320x320, README.md:146-147) counts one MAC per
multiply-add; we report the same quantity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

from ..config import ModelConfig, SCRFDConfig


def _conv_macs(h, w, cin, cout, k, groups=1, stride=1):
    """mmcv convention: out_numel*(cin/groups*k^2) conv MACs + out_numel
    bias adds."""
    oh, ow = h // stride, w // stride
    out_numel = oh * ow * cout
    return out_numel * ((cin // groups) * k * k + 1), oh, ow


def _bn_relu_macs(h, w, c, with_relu=True):
    """mmcv: affine BN = 2*numel, ReLU = numel."""
    numel = h * w * c
    return 2 * numel + (numel if with_relu else 0)


def _conv_dp_macs(h, w, cin, cout, with_bn=True):
    m1, h, w = _conv_macs(h, w, cin, cout, 1)
    m2, h, w = _conv_macs(h, w, cout, cout, 3, groups=cout)
    mb = _bn_relu_macs(h, w, cout) if with_bn else 0
    return m1 + m2 + mb, h, w


def count_macs(cfg: ModelConfig | SCRFDConfig,
               input_size: Tuple[int, int] = (320, 320)) -> int:
    if isinstance(cfg, SCRFDConfig):
        return scrfd_macs(cfg, input_size)
    h, w = input_size
    total = 0
    # stem: 3x3/2 conv + ConvDPUnit
    c_in, c_mid, c_out = cfg.stage_channels[0]
    m, h, w = _conv_macs(h, w, c_in, c_mid, 3, stride=2)
    total += m + _bn_relu_macs(h, w, c_mid)
    m, h, w = _conv_dp_macs(h, w, c_mid, c_out)
    total += m
    c = c_out
    feats: List[Tuple[int, int, int]] = []
    if 0 in cfg.out_idx:
        feats.append((h, w, c))
    if 0 in cfg.downsample_idx:
        total += h * w * c  # maxpool (mmcv: input numel)
        h, w = h // 2, w // 2
    for i in range(1, len(cfg.stage_channels)):
        cin, cout = cfg.stage_channels[i]
        m, h, w = _conv_dp_macs(h, w, cin, cin)
        total += m
        m, h, w = _conv_dp_macs(h, w, cin, cout)
        total += m
        c = cout
        if i in cfg.out_idx:
            feats.append((h, w, c))
        if i in cfg.downsample_idx:
            total += h * w * c
            h, w = h // 2, w // 2
    # neck: lateral convs (+ nearest upsample output numel for upper levels)
    for lvl, (fh, fw, fc) in enumerate(feats):
        m, _, _ = _conv_dp_macs(fh, fw, fc, fc)
        total += m
        if lvl > 0:  # upsampled and added into the level below
            total += (fh * 2) * (fw * 2) * fc
    # head
    for (fh, fw, fc) in feats:
        cch = fc
        for _ in range(cfg.shared_stacked_convs):
            m, _, _ = _conv_dp_macs(fh, fw, cch, cfg.feat_channels)
            total += m
            cch = cfg.feat_channels
        for out_ch in (cfg.num_classes, 4, 1,
                       cfg.kps_num * 2 if cfg.use_kps else 0):
            if out_ch:
                m, _, _ = _conv_dp_macs(fh, fw, cch, out_ch,
                                        with_bn=False)
                total += m
    return total


def count_params(cfg: ModelConfig | SCRFDConfig) -> int:
    from ..models import architecture
    # on the meta device: shapes only, no parameter memory
    return architecture(cfg)(cfg, device="meta").num_params


class Conv(NamedTuple):
    """One conv of SCRFD: input h x w, channels, kernel, stride, whether
    it has a bias, a BN, and a ReLU on its output (a block's second conv
    counts the ReLU after its shortcut's add)."""
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    bias: bool
    bn: bool
    relu: bool

    @property
    def out(self) -> Tuple[int, int]:
        return self.h // self.stride, self.w // self.stride

    @property
    def macs(self) -> int:
        oh, ow = self.out
        return oh * ow * self.cout * self.cin * self.k * self.k


def scrfd_convs(cfg: SCRFDConfig, h: int, w: int) -> List[Conv]:
    """Every conv of one SCRFD forward at h x w, in the order of
    ``models/scrfd.py:scrfd_forward`` (58 at scrfd_10g_bnkps)."""
    out: List[Conv] = []
    c0, c1, c2 = cfg.stem_channels
    out += [Conv(h, w, 3, c0, 3, 2, False, True, True),
            Conv(h // 2, w // 2, c0, c1, 3, 1, False, True, True),
            Conv(h // 2, w // 2, c1, c2, 3, 1, False, True, True)]
    h, w, cin = h // 4, w // 4, c2
    sizes = []
    for s, (n, planes) in enumerate(zip(cfg.stage_blocks,
                                        cfg.stage_planes)):
        for j in range(n):
            st = 2 if s > 0 and j == 0 else 1
            ho, wo = h // st, w // st
            out += [Conv(h, w, cin, planes, 3, st, False, True, True),
                    Conv(ho, wo, planes, planes, 3, 1, False, True, True)]
            if st != 1 or cin != planes:
                out.append(Conv(ho, wo, cin, planes, 1, 1, False, True,
                                False))
            h, w, cin = ho, wo, planes
        sizes.append((h, w, planes))
    levels = sizes[cfg.neck_start_level:]
    c = cfg.neck_out_channels
    out += [Conv(lh, lw, lc, c, 1, 1, True, False, False)
            for lh, lw, lc in levels]
    out += [Conv(lh, lw, c, c, 3, 1, True, False, False)
            for lh, lw, _ in levels]
    out += [Conv(lh, lw, c, c, 3, 2, True, False, False)
            for lh, lw, _ in levels[:-1]]
    out += [Conv(lh, lw, c, c, 3, 1, True, False, False)
            for lh, lw, _ in levels[1:]]
    a, fc = cfg.num_anchors, cfg.feat_channels
    heads = [cfg.num_classes * a, 4 * a] + (
        [2 * cfg.kps_num * a] if cfg.use_kps else [])
    for lh, lw, _ in levels:
        out += [Conv(lh, lw, c if j == 0 else fc, fc, 3, 1, False, True,
                     True) for j in range(cfg.stacked_convs)]
        out += [Conv(lh, lw, fc, o, 3, 1, True, False, False)
                for o in heads]
    return out


def scrfd_macs(cfg: SCRFDConfig, input_size: Tuple[int, int]) -> int:
    """SCRFD's multiply-accumulates as mmcv's counter counts its modules:
    a conv's multiply-adds plus its output's size for a bias, a BN twice
    its input's size, a ReLU its output's size (a block's two each), a
    pool its input's size. The functional upsample and adds, and the
    Scale, are not modules it counts."""
    h, w = input_size
    total = cfg.stem_channels[-1] * (h // 2) * (w // 2)      # the max pool
    for c in scrfd_convs(cfg, h, w):
        oh, ow = c.out
        total += c.macs + oh * ow * c.cout * (c.bias + 2 * c.bn + c.relu)
        if c.k == 1 and c.bn:                         # an avg-down's pool
            total += c.cin * (c.h * 2) * (c.w * 2)
    return total
