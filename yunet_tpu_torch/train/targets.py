"""Training targets from SimOTA assignment, fixed shapes — counterpart of
``yunet_tpu/train/targets.py`` (reference yunet_head.py:536-604):

  - priors are offset by +0.5*stride for assignment only (:570-577);
  - cls target = one-hot(label) * matched IoU (soft label, :587-588);
  - obj target = the fg mask over all priors (:590-591);
  - bbox / kps targets = the matched GT's box / keypoints, the kps weight
    the face's mean keypoint visibility on fg (:595-600).

Every target keeps the (B, P, ...) prior-aligned shape beside the fg mask;
the loss weights make the background entries free.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.assign import AssignResult, sim_ota_assign_batched
from ..ops.boxes import fuse_score


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (B, G, D) table at (B, P) indices -> (B, P, D)."""
    return torch.gather(table, 1, idx[..., None].expand(*idx.shape,
                                                        table.shape[-1]))


def targets_from_assign(res: AssignResult, gt_bboxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_kps: torch.Tensor, *,
                        num_classes: int, kps_num: int
                        ) -> Dict[str, torch.Tensor]:
    """Prior-aligned targets from an AssignResult, batched. The matched GT
    row is gathered (JAX selects it with a one-hot matmul, a TPU
    workaround with the same values)."""
    fg = res.fg_mask
    b, g = gt_labels.shape
    idx = res.matched_gt.long()
    kps_w = _pick(gt_kps[..., 2].mean(-1, keepdim=True), idx)[..., 0]
    onehot = F.one_hot(gt_labels.long(), num_classes).float()
    return {
        "fg": fg,
        "cls": _pick(onehot, idx) * res.matched_iou[..., None],
        "obj": fg.float(),
        "bbox": _pick(gt_bboxes, idx),
        "kps": _pick(gt_kps[..., :2].reshape(b, g, kps_num * 2), idx),
        "kps_weight": torch.where(fg, kps_w, torch.zeros_like(kps_w)),
        "num_pos": fg.sum(-1).float(),
    }


def build_targets_batched(cls_logits: torch.Tensor, obj_logits: torch.Tensor,
                          priors: torch.Tensor, decoded_bboxes: torch.Tensor,
                          gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                          gt_kps: torch.Tensor, gt_valid: torch.Tensor, *,
                          num_classes: int, kps_num: int,
                          center_radius: float, candidate_topk: int,
                          iou_weight: float, cls_weight: float,
                          use_streamed: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Batched targets: cls_logits (B, P, C), obj_logits (B, P), priors
    (P, 4) shared (not offset), decoded (B, P, 4), gt_* (B, G, ...).
    use_streamed selects the streamed SimOTA (the CUDA kernel for CUDA
    tensors) over the dense one (``ops/assign.py``)."""
    scores = fuse_score(cls_logits, obj_logits[..., None])
    offset_priors = torch.cat(
        [priors[:, :2] + priors[:, 2:] * 0.5, priors[:, 2:]], dim=-1)
    res = sim_ota_assign_batched(
        scores, offset_priors, decoded_bboxes, gt_bboxes, gt_labels,
        gt_valid, center_radius=center_radius,
        candidate_topk=candidate_topk, iou_weight=iou_weight,
        cls_weight=cls_weight, use_streamed=use_streamed)
    return targets_from_assign(res, gt_bboxes, gt_labels, gt_kps,
                               num_classes=num_classes, kps_num=kps_num)
