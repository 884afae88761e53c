"""Model arithmetic from a configuration file's ``model`` group, frozen: a
copy of ``yunet_tpu_torch/utils/flops.py:count_macs`` (one MAC per
multiply-add, plus bias, BN and ReLU terms, as mmcv counts them) and of
``chip_smoke.py:convdp_unit_shapes``, on plain dicts.
"""

from __future__ import annotations

from typing import List, Tuple


def _conv_macs(h, w, cin, cout, k, groups=1, stride=1):
    oh, ow = h // stride, w // stride
    return oh * ow * cout * ((cin // groups) * k * k + 1), oh, ow


def _bn_relu_macs(h, w, c, with_relu=True):
    numel = h * w * c
    return 2 * numel + (numel if with_relu else 0)


def _conv_dp_macs(h, w, cin, cout, with_bn=True):
    m1, h, w = _conv_macs(h, w, cin, cout, 1)
    m2, h, w = _conv_macs(h, w, cout, cout, 3, groups=cout)
    mb = _bn_relu_macs(h, w, cout) if with_bn else 0
    return m1 + m2 + mb, h, w


def count_macs(model: dict, input_size: Tuple[int, int]) -> int:
    """Multiply-accumulates of one forward pass of one image."""
    h, w = input_size
    stages = model["stage_channels"]
    total = 0
    c_in, c_mid, c_out = stages[0]
    m, h, w = _conv_macs(h, w, c_in, c_mid, 3, stride=2)
    total += m + _bn_relu_macs(h, w, c_mid)
    m, h, w = _conv_dp_macs(h, w, c_mid, c_out)
    total += m
    feats: List[Tuple[int, int, int]] = []
    if 0 in model["out_idx"]:
        feats.append((h, w, c_out))
    if 0 in model["downsample_idx"]:
        total += h * w * c_out
        h, w = h // 2, w // 2
    for i in range(1, len(stages)):
        cin, cout = stages[i]
        m, h, w = _conv_dp_macs(h, w, cin, cin)
        total += m
        m, h, w = _conv_dp_macs(h, w, cin, cout)
        total += m
        if i in model["out_idx"]:
            feats.append((h, w, cout))
        if i in model["downsample_idx"]:
            total += h * w * cout
            h, w = h // 2, w // 2
    for lvl, (fh, fw, fc) in enumerate(feats):
        total += _conv_dp_macs(fh, fw, fc, fc)[0]
        if lvl > 0:
            total += (fh * 2) * (fw * 2) * fc
    for (fh, fw, fc) in feats:
        cch = fc
        for _ in range(model["shared_stacked_convs"]):
            total += _conv_dp_macs(fh, fw, cch, model["feat_channels"])[0]
            cch = model["feat_channels"]
        for out_ch in (model["num_classes"], 4, 1,
                       model["kps_num"] * 2 if model["use_kps"] else 0):
            if out_ch:
                total += _conv_dp_macs(fh, fw, cch, out_ch,
                                       with_bn=False)[0]
    return total


def convdp_units(model: dict, h: int, w: int) -> List[Tuple[int, ...]]:
    """(h, w, cin, cout) of every ConvDPUnit of one forward at h x w, in
    the forward's order: the stem's unit, two a stage, a lateral unit a
    level, then the head's shared and branch units."""
    stages = model["stage_channels"]
    h, w = h // 2, w // 2
    units = [(h, w, stages[0][1], stages[0][2])]
    levels = []
    for i in range(len(stages)):
        if i > 0:
            cin, cout = stages[i]
            units += [(h, w, cin, cin), (h, w, cin, cout)]
        if i in model["out_idx"]:
            levels.append((h, w, stages[i][-1]))
        if i in model["downsample_idx"]:
            h, w = h // 2, w // 2
    outs = [model["num_classes"], 4, 1] + (
        [model["kps_num"] * 2] if model["use_kps"] else [])
    for lh, lw, c in levels:
        units.append((lh, lw, c, c))
        cch = c
        for _ in range(model["shared_stacked_convs"]):
            units.append((lh, lw, cch, model["feat_channels"]))
            cch = model["feat_channels"]
        units += [(lh, lw, cch, o) for o in outs]
    return units
