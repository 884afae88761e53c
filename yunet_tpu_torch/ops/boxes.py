"""Box / keypoint decode-encode, IoU and score fusion on tensors
(counterpart of ``yunet_tpu/ops/boxes.py``).

  bbox:  cxy = pred[..., :2] * stride + prior_xy
         wh  = exp(pred[..., 2:]) * stride
         corners = cxy -+ wh/2
  kps:   kp_i = pred[..., 2i:2i+2] * stride + prior_xy
  score = sigmoid(cls) * sigmoid(obj)

SCRFD's head predicts distances from the anchor point instead:

  bbox:  corners = prior_xy -+ pred[..., (l, t) | (r, b)] * stride
  score = sigmoid(cls), with no objectness

RetinaFace's, offsets from SSD prior boxes [cx, cy, w, h] with variances
(v0, v1) (``ssd_box_decode``, ``ssd_kps_decode``):

  bbox:  c = prior_c + pred[..., :2] * v0 * prior_wh
         wh = prior_wh * exp(pred[..., 2:] * v1)
         (x1, y1) = c - wh / 2, (x2, y2) = (x1, y1) + wh
  kps:   kp_i = prior_c + pred[..., 2i:2i+2] * v0 * prior_wh
  score = softmax(cls)[..., 1] of two logits an anchor
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


def distance_decode(priors: torch.Tensor, dist_pred: torch.Tensor
                    ) -> torch.Tensor:
    """priors (..., P, 4) [x, y, sw, sh]; dist_pred (..., P, 4) ltrb in
    strides -> xyxy (SCRFD's distance2bbox, unclipped)."""
    xy, s = priors[..., :2], priors[..., 2:]
    return torch.cat([xy - dist_pred[..., :2] * s,
                      xy + dist_pred[..., 2:] * s], dim=-1)


def kps_decode(priors: torch.Tensor, kps_pred: torch.Tensor) -> torch.Tensor:
    """kps_pred (..., P, 2K) -> absolute keypoint coords (..., P, 2K)."""
    nk = kps_pred.shape[-1] // 2
    pts = kps_pred.reshape(*kps_pred.shape[:-1], nk, 2)
    pts = pts * priors[..., None, 2:] + priors[..., None, :2]
    return pts.reshape(kps_pred.shape)


def ssd_box_decode(priors: torch.Tensor, loc: torch.Tensor, variance
                   ) -> torch.Tensor:
    """priors (..., P, 4) [cx, cy, w, h]; loc (..., P, 4) -> xyxy, in the
    order of operations of RetinaFace's ``utils/box_utils.py:decode``."""
    v0, v1 = variance
    c = priors[..., :2] + loc[..., :2] * v0 * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * v1)
    lt = c - wh / 2
    return torch.cat([lt, lt + wh], dim=-1)


def ssd_kps_decode(priors: torch.Tensor, ldm: torch.Tensor, v0: float
                   ) -> torch.Tensor:
    """ldm (..., P, 2K) offsets -> keypoints (..., P, 2K): each point the
    prior's centre + offset * v0 * the prior's size (``decode_landm``)."""
    nk = ldm.shape[-1] // 2
    pts = ldm.reshape(*ldm.shape[:-1], nk, 2)
    pts = priors[..., None, :2] + pts * v0 * priors[..., None, 2:]
    return pts.reshape(ldm.shape)


def softmax_score(cls_logits: torch.Tensor) -> torch.Tensor:
    """(..., 2) background and face logits -> the face's softmax."""
    return torch.softmax(cls_logits, dim=-1)[..., 1]


def kps_encode(priors: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """Inverse of kps_decode (reference yunet_head.py:395-402)."""
    nk = kps.shape[-1] // 2
    pts = kps.reshape(*kps.shape[:-1], nk, 2)
    pts = (pts - priors[..., None, :2]) / priors[..., None, 2:]
    return pts.reshape(kps.shape)


def fuse_score(cls_logit: torch.Tensor, obj_logit: torch.Tensor
               ) -> torch.Tensor:
    return torch.sigmoid(cls_logit) * torch.sigmoid(obj_logit)


# the IoU denominator floor shared by pairwise_iou and aligned_iou: the
# streamed SimOTA tail recomputes the matched IoU with aligned_iou, the
# dense SimOTA reads it from the pairwise matrix, and the two must agree
IOU_EPS = 1e-6


def _area(b: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0.0))


def aligned_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                eps: float = IOU_EPS) -> torch.Tensor:
    """Element-wise IoU of aligned (..., 4) xyxy boxes (mmcv
    bbox_overlaps with is_aligned=True; no +1 offset)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(_area(boxes1) + _area(boxes2) - inter,
                               min=eps)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = IOU_EPS) -> torch.Tensor:
    """IoU matrix (..., N, M) between xyxy boxes (..., N, 4) and
    (..., M, 4), with aligned_iou's clip and eps conventions."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(boxes1)[..., :, None] + _area(boxes2)[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)
