"""YuNet detector: backbone -> neck -> head — counterpart of
``yunet_tpu/models/detector.py:23-113``.

Submodules are named ``backbone``, ``neck`` and ``bbox_head``, as in the
reference checkpoint, so ``load_state_dict`` takes a reference
``state_dict`` as it is. The network eats raw 0-255 BGR (the reference's
img_norm_cfg is the identity, configs/yunet_n.py:27).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.boxes import bbox_decode, fuse_score, kps_decode
from .backbone import YuNetBackbone
from .fused import fold_inference_params, fused_forward
from .head import YuNetHead, flatten_level_outputs
from .neck import TFPN


class YuNet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device,
                 generator: Optional[torch.Generator] = None):
        """Builds the model on ``device``. Weights are drawn from
        ``generator`` (on the generator's device, so they do not depend
        on ``device``); with no generator they are zero, for a model that
        is about to load a checkpoint."""
        super().__init__()
        self.cfg = cfg
        self.backbone = YuNetBackbone(cfg.stage_channels,
                                      cfg.downsample_idx, cfg.out_idx)
        self.neck = TFPN(cfg.neck_in_channels)
        self.bbox_head = YuNetHead(
            num_levels=len(cfg.strides), in_channels=cfg.head_in_channels,
            feat_channels=cfg.feat_channels,
            shared_stacked_convs=cfg.shared_stacked_convs,
            num_classes=cfg.num_classes, kps_num=cfg.kps_num,
            use_kps=cfg.use_kps)
        # built on the meta device: no parameter memory and no draw from
        # the global RNG until the explicit init below
        self.to_empty(device=device)
        self.reset_parameters(generator)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator]):
        self.backbone.reset_parameters(generator)
        self.neck.reset_parameters(generator)
        self.bbox_head.reset_parameters(generator)

    def forward(self, x: torch.Tensor, bn_group: int = 0,
                fused: bool = False) -> Dict[str, List[torch.Tensor]]:
        """x: (B, 3, H, W) raw BGR, H and W multiples of 32. Returns the
        per-level NCHW maps of each head branch. In training mode
        (``self.train()``) BatchNorm uses batch statistics, over groups of
        ``bn_group`` samples when 0 < bn_group < B (GhostBN), and updates
        its running statistics in place. ``fused`` runs every ConvDPUnit's
        pw + dw through the fused kernel pair (``ops/convdp_train.py``;
        JAX ``forward(fused=True)``); it takes precedence over
        ``cfg.composed_dp``, as in JAX. Give it a channels-last x to keep
        the trunk channels-last, where the units' NHWC views are free."""
        return self.bbox_head(
            self.neck(self.backbone(x, bn_group, fused), bn_group, fused),
            bn_group, fused)

    def forward_flat(self, x: torch.Tensor, bn_group: int = 0,
                     fused: bool = False) -> Dict[str, torch.Tensor]:
        """Forward + per-level flatten to (B, P, C) tensors (prior order)."""
        return flatten_level_outputs(self.forward(x, bn_group, fused))

    def feature_test(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Raw multi-level outputs flattened in the reference export order
        (yunet.py:69-86): cls_8..32, obj_8..32, bbox_8..32, kps_8..32."""
        outs = self.forward(x)
        return [m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, m.shape[1])
                for k in ("cls", "obj", "bbox", "kps") if k in outs
                for m in outs[k]]

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def fold(self, dtype: torch.dtype) -> Dict[str, Any]:
        return fold_inference_params(self, self.cfg)   # f32 for any trunk

    @staticmethod
    def forward_folded(folded: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig, *, use_kernel: bool
                       ) -> Dict[str, torch.Tensor]:
        return flatten_level_outputs(fused_forward(folded, x, cfg,
                                                   use_kernel=use_kernel))

    @staticmethod
    def decode(flat: Dict[str, torch.Tensor], priors: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (fuse_score(flat["cls"][..., 0].float(),
                           flat["obj"][..., 0].float()),
                bbox_decode(priors, flat["bbox"].float()),
                kps_decode(priors, flat["kps"].float()))

    @staticmethod
    def num_anchors(cfg: ModelConfig) -> int:
        return 1
