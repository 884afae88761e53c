"""YuNet backbone — counterpart of ``yunet_tpu/models/backbone.py:85-111``
(reference mmdet/models/backbones/yunet_backbone.py:8-41).

Six sequential stages (stem + five Conv4layerBlocks), with a 2x2/2 max
pool after the stages in ``downsample_idx`` and features emitted for the
stages in ``out_idx``. ``F.max_pool2d(x, 2)`` floors odd sizes exactly as
the JAX ``max_pool2x_reduce_window`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv4LayerBlock, ConvHead


class YuNetBackbone(nn.Module):
    def __init__(self, stage_channels: Sequence[Sequence[int]],
                 downsample_idx: Sequence[int], out_idx: Sequence[int]):
        super().__init__()
        self.downsample_idx = tuple(downsample_idx)
        self.out_idx = tuple(out_idx)
        self.num_stages = len(stage_channels)
        self.model0 = ConvHead(*stage_channels[0])
        for i in range(1, self.num_stages):
            self.add_module(f"model{i}", Conv4LayerBlock(*stage_channels[i]))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        for i in range(self.num_stages):
            getattr(self, f"model{i}").reset_parameters(generator)

    def forward(self, x: torch.Tensor, bn_group: int = 0
                ) -> List[torch.Tensor]:
        outs: List[torch.Tensor] = []
        for i in range(self.num_stages):
            x = getattr(self, f"model{i}")(x, bn_group)
            if i in self.out_idx:
                outs.append(x)
            if i in self.downsample_idx:
                x = F.max_pool2d(x, 2)
        return outs
