"""Box / keypoint decode and score fusion on tensors
(counterpart of ``yunet_tpu/ops/boxes.py:18-43``).

  bbox:  cxy = pred[..., :2] * stride + prior_xy
         wh  = exp(pred[..., 2:]) * stride
         corners = cxy -+ wh/2
  kps:   kp_i = pred[..., 2i:2i+2] * stride + prior_xy
  score = sigmoid(cls) * sigmoid(obj)
"""

from __future__ import annotations

import torch


def bbox_decode(priors: torch.Tensor, bbox_pred: torch.Tensor
                ) -> torch.Tensor:
    """priors (..., P, 4) [x, y, sw, sh]; bbox_pred (..., P, 4) -> xyxy."""
    xys = bbox_pred[..., :2] * priors[..., 2:] + priors[..., :2]
    whs = torch.exp(bbox_pred[..., 2:]) * priors[..., 2:]
    half = whs * 0.5
    return torch.cat([xys - half, xys + half], dim=-1)


def kps_decode(priors: torch.Tensor, kps_pred: torch.Tensor) -> torch.Tensor:
    """kps_pred (..., P, 2K) -> absolute keypoint coords (..., P, 2K)."""
    nk = kps_pred.shape[-1] // 2
    pts = kps_pred.reshape(*kps_pred.shape[:-1], nk, 2)
    pts = pts * priors[..., None, 2:] + priors[..., None, :2]
    return pts.reshape(kps_pred.shape)


def fuse_score(cls_logit: torch.Tensor, obj_logit: torch.Tensor
               ) -> torch.Tensor:
    return torch.sigmoid(cls_logit) * torch.sigmoid(obj_logit)
