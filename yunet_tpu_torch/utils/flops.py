"""Analytic complexity counter (params + multiply-accumulates) — a copy of
``yunet_tpu/utils/flops.py`` (framework-neutral; a test holds the counts
equal to the original's).

Replaces tools/get_flops.py + mmcv get_model_complexity_info: the model is
a fixed conv pipeline, so MACs are computed in closed form from the
architecture plan. The mmcv convention reported in the reference README
("MFLOPs" 149/96 @320x320, README.md:146-147) counts one MAC per
multiply-add; we report the same quantity.
"""

from __future__ import annotations

from typing import List, Tuple

from ..config import ModelConfig


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


def count_macs(cfg: ModelConfig, input_size: Tuple[int, int] = (320, 320)
               ) -> int:
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


def count_params(cfg: ModelConfig) -> int:
    from ..models.detector import YuNet
    # on the meta device: shapes only, no parameter memory
    return YuNet(cfg, device="meta").num_params
