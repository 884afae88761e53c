"""YuNet head — counterpart of ``yunet_tpu/models/head.py`` (reference
mmdet/models/dense_heads/yunet_head.py:112-247).

Per level: an optional shared ConvDPUnit stack, then four prediction
ConvDPUnits without BN — cls (num_classes ch), bbox (4), obj (1) and
kps (2*NK). The four branches stay separate modules under the reference
names; the JAX package concatenates them into one unit for TPU tiling,
which is the same math (with ``fused``: four fused units a level where
JAX runs one).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from .layers import ConvDPUnit

BRANCHES = ("cls", "bbox", "obj", "kps")


class YuNetHead(nn.Module):
    def __init__(self, *, num_levels: int, in_channels: int,
                 feat_channels: int, shared_stacked_convs: int,
                 num_classes: int, kps_num: int, use_kps: bool = True):
        super().__init__()
        if shared_stacked_convs > 0:
            self.multi_level_share_convs = nn.ModuleList(
                nn.ModuleList(
                    ConvDPUnit(in_channels if i == 0 else feat_channels,
                               feat_channels, with_bn=True)
                    for i in range(shared_stacked_convs))
                for _ in range(num_levels))
            chn = feat_channels
        else:
            self.multi_level_share_convs = None
            chn = in_channels
        out_ch = {"cls": num_classes, "bbox": 4, "obj": 1,
                  "kps": kps_num * 2}
        self.branches = BRANCHES if use_kps else BRANCHES[:3]
        for b in self.branches:
            self.add_module(f"multi_level_{b}", nn.ModuleList(
                ConvDPUnit(chn, out_ch[b], with_bn=False)
                for _ in range(num_levels)))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        # level-major, as the JAX init walks it (the draws differ from
        # jax.random anyway; the order only keeps init reproducible)
        num_levels = len(getattr(self, f"multi_level_{self.branches[0]}"))
        for lvl in range(num_levels):
            if self.multi_level_share_convs is not None:
                for m in self.multi_level_share_convs[lvl]:
                    m.reset_parameters(generator)
            for b in self.branches:
                getattr(self, f"multi_level_{b}")[lvl].reset_parameters(
                    generator)

    def forward(self, feats: List[torch.Tensor], bn_group: int = 0,
                fused: bool = False) -> Dict[str, List[torch.Tensor]]:
        """Per-level NCHW maps for each branch."""
        out: Dict[str, List[torch.Tensor]] = {b: [] for b in self.branches}
        for lvl, feat in enumerate(feats):
            if self.multi_level_share_convs is not None:
                for m in self.multi_level_share_convs[lvl]:
                    feat = m(feat, bn_group, fused)
            for b in self.branches:
                out[b].append(getattr(self, f"multi_level_{b}")[lvl](
                    feat, fused=fused))
        return out


def flatten_level_outputs(out: Dict[str, List[torch.Tensor]],
                          num_anchors: int = 1) -> Dict[str, torch.Tensor]:
    """Per-level NCHW maps of num_anchors * C channels -> (B, P, C), per
    level row-major over (H, W), anchor-minor (yunet_head.py:331-349)."""
    return {k: torch.cat([m.permute(0, 2, 3, 1).reshape(
                m.shape[0], -1, m.shape[1] // num_anchors) for m in maps],
                dim=1)
            for k, maps in out.items()}
