"""RetinaFace's arithmetic from a configuration file's ``model`` group,
frozen: the convs of one forward pass, the multiply-accumulates as mmcv's
complexity counter counts them (as ``scrfd.count_macs`` does SCRFD's),
and the least time for the convs on the card (``peaks.bound_ms``), each
level's three heads as one conv.
"""

from __future__ import annotations

from typing import List, Tuple

from .peaks import BF16_FLOPS, bound_ms
from .scrfd import Conv


def convs(m: dict, h: int, w: int) -> List[Conv]:
    """Every conv of one forward at h x w (multiples of 32), in the
    unfused model's order: the stem; each Bottleneck's 1x1, 3x3 (the
    stage's stride) and 1x1, then its shortcut's strided 1x1; the FPN's
    laterals and merges; each level's five SSH convs; the class, box and
    landmark heads level by level (82 at RetinaFace-R50). ``relu`` marks a
    ReLU module on the output: a Bottleneck's third conv carries the one
    after its add; the SSH's first conv and branch ends carry none (its
    final ReLU is functional)."""
    c = m["stem_channels"]
    out = [Conv(h, w, 3, c, 7, 2, False, True, True)]
    h, w, cin = h // 4, w // 4, c
    sizes = []
    for s, (n, planes) in enumerate(zip(m["stage_blocks"],
                                        m["stage_planes"])):
        cout = planes * m["expansion"]
        for j in range(n):
            st = 2 if s > 0 and j == 0 else 1
            ho, wo = h // st, w // st
            out += [Conv(h, w, cin, planes, 1, 1, False, True, True),
                    Conv(h, w, planes, planes, 3, st, False, True, True),
                    Conv(ho, wo, planes, cout, 1, 1, False, True, True)]
            if st != 1 or cin != cout:
                out.append(Conv(h, w, cin, cout, 1, st, False, True, False))
            h, w, cin = ho, wo, cout
        sizes.append((h, w, cout))
    levels = sizes[m["neck_start_level"]:]
    o = m["out_channel"]
    out += [Conv(lh, lw, lc, o, 1, 1, False, True, True)
            for lh, lw, lc in levels]
    out += [Conv(lh, lw, o, o, 3, 1, False, True, True)
            for lh, lw, _ in levels[:-1]]
    for lh, lw, _ in levels:
        out += [Conv(lh, lw, o, o // 2, 3, 1, False, True, False),
                Conv(lh, lw, o, o // 4, 3, 1, False, True, True),
                Conv(lh, lw, o // 4, o // 4, 3, 1, False, True, False),
                Conv(lh, lw, o // 4, o // 4, 3, 1, False, True, True),
                Conv(lh, lw, o // 4, o // 4, 3, 1, False, True, False)]
    a = m["num_anchors"]
    for per in (2, 4, 2 * m["kps_num"]):
        out += [Conv(lh, lw, o, a * per, 1, 1, True, False, False)
                for lh, lw, _ in levels]
    return out


def count_macs(m: dict, input_size: Tuple[int, int]) -> int:
    """Multiply-accumulates of one forward pass of one image, as mmcv's
    counter counts a module: a conv's multiply-adds plus its output's
    size for a bias, a BN twice its output's size, a ReLU module its
    output's size (a Bottleneck's one ReLU three times), the max pool its
    input's size. The functional upsample, adds, concatenation and the
    SSH's final ReLU are not modules it counts."""
    h, w = input_size
    total = m["stem_channels"] * (h // 2) * (w // 2)        # the max pool
    for c in convs(m, h, w):
        oh, ow = c.out
        total += c.macs + oh * ow * c.cout * (c.bias + 2 * c.bn + c.relu)
    return total


def merged_convs(m: dict, h: int, w: int) -> List[Conv]:
    """``convs`` with each level's class, box and landmark heads as one
    conv of their summed outputs (256 -> 32 at RetinaFace-R50): the three
    read the same map, so the function needs that map read once."""
    body = [c for c in convs(m, h, w) if not c.bias]
    heads = [c for c in convs(m, h, w) if c.bias]
    levels = len(heads) // 3
    return body + [c._replace(cout=sum(x.cout for x in heads[i::levels]))
                   for i, c in enumerate(heads[:levels])]


def conv_bound_ms(m: dict, h: int, w: int, batch: int = 1) -> float:
    """The least time (ms) for the convs of one forward of ``batch``
    images at h x w on an H100, conv by conv over ``merged_convs`` (a
    level's heads read their map once): bf16 activations read and written
    once, bf16 weights and biases read once, 2 x the multiply-adds at the
    bf16 tensor-core peak."""
    total = 0.0
    for c in merged_convs(m, h, w):
        oh, ow = c.out
        act = (c.h * c.w * c.cin + oh * ow * c.cout) * batch
        wts = c.cout * c.cin * c.k * c.k + c.cout
        total += bound_ms(2 * (act + wts), 2 * c.macs * batch, BF16_FLOPS)
    return total
