"""SimOTA label assignment with fixed shapes — counterpart of
``yunet_tpu/ops/assign.py``.

Two formulations with the same answers (reference SimOTAAssigner,
sim_ota_assigner.py:95-257):

  * ``sim_ota_assign``: dense, from (B, P, G) cost and IoU tensors — tiered
    INF/BIG masking, dynamic-k from the top-k IoU sum, the k smallest
    costs per GT (ties to the lower prior index), multi-match resolution to
    the argmin-cost GT over all columns;
  * ``assemble_streamed``: the same tail from the streamed reductions of
    ``ops/simota.py`` (the CUDA kernel on the card), which never form the
    (B, P, G) tensors.

``sim_ota_assign_batched`` picks one from the config, never from the
device: ``use_streamed`` (``cfg.train.pallas_simota``) with a single class
takes the streamed path; otherwise the dense one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import aligned_iou
from .simota import dense_cost, streamed_simota, topk_min_idx


class AssignResult(NamedTuple):
    fg_mask: torch.Tensor       # (B, P) bool — positive priors
    matched_gt: torch.Tensor    # (B, P) i32 — GT row (0 if background)
    matched_iou: torch.Tensor   # (B, P) f32 — IoU with it (0 if bg)


def dynamic_k(topk_iou: torch.Tensor, gt_valid: torch.Tensor
              ) -> torch.Tensor:
    """int(sum of the top-k IoUs) floored at 1, 0 on invalid GTs. Summed
    left to right in descending order, as JAX does (assign.py:182-187):
    one ulp can move the sum across an integer."""
    tot = topk_iou[..., 0]
    for i in range(1, topk_iou.shape[-1]):
        tot = tot + topk_iou[..., i]
    ks = torch.clamp(tot.to(torch.int32), min=1)
    return torch.where(gt_valid, ks, torch.zeros_like(ks))


def sim_ota_assign(pred_scores: torch.Tensor, priors: torch.Tensor,
                   decoded_bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor, *,
                   center_radius: float = 2.5, candidate_topk: int = 10,
                   iou_weight: float = 3.0, cls_weight: float = 1.0,
                   eps: float = 1e-7) -> AssignResult:
    """Dense SimOTA, batched by the leading dimension (JAX vmaps its
    single-image form). pred_scores (B, P, C) fused probabilities; priors
    (P, 4) [cx, cy, sw, sh] already offset by +0.5*stride; decoded_bboxes
    (B, P, 4) xyxy; gt_bboxes (B, G, 4), gt_labels (B, G), gt_valid (B, G)
    bool, padded."""
    p = priors.shape[0]
    g = gt_bboxes.shape[1]
    onehot = F.one_hot(gt_labels.long(), pred_scores.shape[-1]).float()
    valid_prior, ious, cost = dense_cost(
        pred_scores, priors, decoded_bboxes, gt_bboxes, onehot, gt_valid,
        center_radius=center_radius, iou_weight=iou_weight,
        cls_weight=cls_weight, eps=eps)

    k_cap = min(candidate_topk, p)
    ious_t = ious.transpose(1, 2)                            # (B, G, P)
    dynamic_ks = dynamic_k(torch.topk(ious_t, k_cap, dim=-1).values,
                           gt_valid)
    cand_idx = topk_min_idx(cost.transpose(1, 2), k_cap)     # (B, G, k)
    take = torch.arange(k_cap, device=cost.device) < dynamic_ks[..., None]
    matching = torch.zeros_like(ious_t, dtype=torch.bool).scatter_(
        -1, cand_idx.long(), take).transpose(1, 2)           # (B, P, G)

    multi = matching.sum(-1) > 1
    best_gt = torch.argmin(cost, dim=-1)                     # all columns
    only_best = F.one_hot(best_gt, g).bool()
    matching = torch.where(multi[..., None], only_best, matching)

    fg_mask = matching.any(-1) & valid_prior
    matched_gt = torch.argmax(matching.to(torch.uint8), dim=-1)
    matched_iou = (matching * ious).sum(-1)
    zero = torch.zeros((), device=cost.device)
    return AssignResult(
        fg_mask, torch.where(fg_mask, matched_gt, 0).to(torch.int32),
        torch.where(fg_mask, matched_iou, zero))


def assemble_streamed(valid_prior: torch.Tensor, best_gt: torch.Tensor,
                      cand_idx: torch.Tensor, topk_iou: torch.Tensor,
                      gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                      decoded: torch.Tensor, *, eps: float = 1e-6
                      ) -> AssignResult:
    """The final matching from the streamed reductions (JAX
    ``_assemble_streamed``, assign.py:169-227), batched: dynamic-k take
    over the ascending-cost candidates, multi-match resolution to the
    argmin-cost GT, and the matched IoU recomputed with aligned_iou. The
    matched GT row is gathered (JAX uses a one-hot matmul, a TPU
    workaround with the same values)."""
    bsz, g, k = cand_idx.shape
    take = (torch.arange(k, device=cand_idx.device)
            < dynamic_k(topk_iou, gt_valid)[..., None])      # (B, G, k)
    flat = cand_idx.reshape(bsz, -1).long()
    zeros = torch.zeros(valid_prior.shape, dtype=torch.int32,
                        device=cand_idx.device)
    count = zeros.scatter_add(1, flat, take.reshape(bsz, -1).to(torch.int32))
    gidx = torch.arange(g, dtype=torch.int32, device=cand_idx.device)
    gsum = zeros.scatter_add(1, flat, (take * gidx[:, None]).reshape(
        bsz, -1).to(torch.int32))

    fg_mask = (count > 0) & valid_prior
    matched_gt = torch.where(count > 1, best_gt, gsum)
    matched_gt = torch.where(fg_mask, matched_gt, 0).to(torch.int32)

    idx = matched_gt.long()
    box = torch.gather(gt_bboxes, 1, idx[..., None].expand(*idx.shape, 4))
    mvalid = torch.gather(gt_valid, 1, idx)
    iou = aligned_iou(decoded, box, eps=eps)
    matched_iou = torch.where(fg_mask & mvalid, iou,
                              torch.zeros((), device=iou.device))
    return AssignResult(fg_mask, matched_gt, matched_iou)


def sim_ota_assign_batched(pred_scores: torch.Tensor, priors: torch.Tensor,
                           decoded_bboxes: torch.Tensor,
                           gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                           gt_valid: torch.Tensor, *,
                           center_radius: float = 2.5,
                           candidate_topk: int = 10,
                           iou_weight: float = 3.0, cls_weight: float = 1.0,
                           eps: float = 1e-7,
                           use_streamed: bool = True) -> AssignResult:
    """Batched SimOTA: pred_scores (B, P, C), priors (P, 4) shared,
    decoded (B, P, 4), gt_* (B, G, ...). use_streamed with a single class
    runs the streamed reductions (``ops/simota.py``: the CUDA kernel for
    CUDA tensors) and ``assemble_streamed``; use_streamed=False runs the
    dense formulation."""
    kw = dict(center_radius=center_radius, iou_weight=iou_weight,
              cls_weight=cls_weight, eps=eps)
    if not use_streamed:
        return sim_ota_assign(pred_scores, priors, decoded_bboxes,
                              gt_bboxes, gt_labels, gt_valid,
                              candidate_topk=candidate_topk, **kw)
    if pred_scores.shape[-1] != 1:
        raise ValueError("the streamed SimOTA requires num_classes == 1")
    sa = streamed_simota(
        pred_scores[..., 0].contiguous(), priors.contiguous(),
        decoded_bboxes.contiguous(), gt_bboxes.contiguous(),
        (gt_labels == 0).float(), gt_valid.contiguous(),
        k=candidate_topk, **kw)
    return assemble_streamed(sa.valid_prior, sa.best_gt, sa.cand_idx,
                             sa.topk_iou, gt_bboxes, gt_valid,
                             decoded_bboxes)
