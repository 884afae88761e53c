"""TFPN neck — counterpart of ``yunet_tpu/models/neck.py:36-52``
(reference mmdet/models/necks/tfpn.py:9-45).

A ConvDPUnit lateral conv per level, applied top-down in place: level i-1
adds the 2x nearest-upsampled, *already laterally convolved* level i before
its own lateral conv runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvDPUnit


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class TFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvDPUnit(c, c, with_bn=True) for c in in_channels)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for m in self.lateral_convs:
            m.reset_parameters(generator)

    def forward(self, feats: List[torch.Tensor], bn_group: int = 0,
                fused: bool = False) -> List[torch.Tensor]:
        feats = list(feats)
        for i in range(len(feats) - 1, 0, -1):
            feats[i] = self.lateral_convs[i](feats[i], bn_group, fused)
            feats[i - 1] = feats[i - 1] + upsample2x_nearest(feats[i])
        feats[0] = self.lateral_convs[0](feats[0], bn_group, fused)
        return feats
