"""Streaming SimOTA reductions — counterpart of
``yunet_tpu/ops/simota_pallas.py:streamed_simota``.

``streamed_simota`` returns, per image, the four small decision tensors
the final matching needs (``ops/assign.py:assemble_streamed``):
valid_prior (B, P) bool, best_gt (B, P) i32, cand_idx (B, G, k) i32 (the k
smallest costs per GT, ascending, ties to the lower prior index) and
topk_iou (B, G, k) f32 (the k largest IoUs per GT, descending).

A CUDA tensor goes to the hand-written kernel (``csrc/simota.cu``: two
launches on the current stream; the (P, G) cost matrix never reaches
device memory). A CPU tensor goes to ``streamed_simota_plain``, which
builds the same outputs densely from (B, P, G) tensors. An invalid GT row
gets cand_idx 0..k-1 and topk_iou 0 from both (its dynamic_k is 0, so the
value never reaches an assignment); the JAX kernel leaves other values
there, so compare raw outputs with it on valid rows only.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)
from .boxes import pairwise_iou
from .losses import bce_probs

INF = 100000.0  # candidate outside GT box & centre region
BIG = 1e9       # invalid prior or padded GT

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SOURCE = os.path.join(CSRC_DIR, "simota.cu")
# -fmad=false: every IoU and cost must round as the plain version's
# separate torch ops do (the source also spells each rounding out)
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS + ["-fmad=false"],
    {**cuda_signatures(
        yunet_simota_valid_best=[_P] * 6 + [_I] * 3 + [_F] * 4 + [_P] * 3,
        yunet_simota_topk=[_P] * 7 + [_I] * 4 + [_F] * 4 + [_P] * 3),
     "yunet_simota_smem_bytes": (ctypes.c_size_t, [_I]),
     "yunet_simota_max_k": (_I, [])})
MAX_STATIC_SMEM = 48 * 1024


class StreamedAssign(NamedTuple):
    valid_prior: torch.Tensor   # (B, P) bool
    best_gt: torch.Tensor       # (B, P) i32 argmin-cost GT per prior
    cand_idx: torch.Tensor      # (B, G, k) i32 k smallest-cost priors
    topk_iou: torch.Tensor      # (B, G, k) f32 k largest IoUs, descending


def _pair_masks(priors: torch.Tensor, gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor, center_radius: float):
    """(B, P, G) in-GT-box and in-centre-region masks
    (simota_pallas.py:102-115, sim_ota_assigner.py:186-228). priors
    (P, 4) [x, y, sx, sy]; gt_bboxes (B, G, 4); gt_valid (B, G)."""
    px, py, sx, sy = (priors[None, :, i, None] for i in range(4))
    x1, y1, x2, y2 = (gt_bboxes[:, None, :, i] for i in range(4))
    gtv = gt_valid[:, None, :]
    in_gts = (torch.minimum(torch.minimum(px - x1, py - y1),
                            torch.minimum(x2 - px, y2 - py)) > 0) & gtv
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    r = center_radius
    in_cts = (torch.minimum(
        torch.minimum(px - (cx - r * sx), py - (cy - r * sy)),
        torch.minimum((cx + r * sx) - px, (cy + r * sy) - py)) > 0) & gtv
    return in_gts, in_cts


def dense_cost(scores, priors, decoded, gt_bboxes, gt_onehot, gt_valid, *,
               center_radius, iou_weight, cls_weight, eps):
    """The SimOTA pair quantities as (B, P, G) tensors: valid_prior
    (B, P), IoU (zeroed off valid pairs) and the tiered cost. scores
    (B, P, C) fused probabilities; gt_onehot (B, G, C)."""
    in_gts, in_cts = _pair_masks(priors, gt_bboxes, gt_valid, center_radius)
    valid_prior = (in_gts | in_cts).any(-1)
    valid_pair = valid_prior[:, :, None] & gt_valid[:, None, :]
    ious = torch.where(valid_pair, pairwise_iou(decoded, gt_bboxes),
                       torch.zeros((), device=decoded.device))
    iou_cost = -torch.log(ious + eps)
    cls_cost = bce_probs(
        torch.sqrt(torch.clamp(scores, 0.0, 1.0))[:, :, None, :],
        gt_onehot[:, None, :, :]).sum(-1)
    cost = (cls_weight * cls_cost + iou_weight * iou_cost
            + (~(in_gts & in_cts)).float() * INF)
    big = torch.full((), BIG, device=cost.device)
    cost = torch.where(valid_pair, cost, big)
    return valid_prior, ious, cost


def topk_min_idx(cost: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, ascending,
    ties to the lower index (a stable sort; torch.topk promises no tie
    order)."""
    return torch.sort(cost, dim=-1, stable=True)[1][..., :k].to(torch.int32)


def streamed_simota_plain(scores, priors, decoded, gt_bboxes, gt_onehot,
                          gt_valid, *, center_radius: float = 2.5,
                          k: int = 10, iou_weight: float = 3.0,
                          cls_weight: float = 1.0,
                          eps: float = 1e-7) -> StreamedAssign:
    """The plain version: the same four outputs from dense (B, P, G)
    tensors (the kernel's arithmetic, op for op)."""
    valid_prior, ious, cost = dense_cost(
        scores[..., None], priors, decoded, gt_bboxes, gt_onehot[..., None],
        gt_valid, center_radius=center_radius, iou_weight=iou_weight,
        cls_weight=cls_weight, eps=eps)
    cost_t = cost.transpose(1, 2)                          # (B, G, P)
    return StreamedAssign(
        valid_prior=valid_prior,
        best_gt=torch.argmin(cost, dim=-1).to(torch.int32),
        cand_idx=topk_min_idx(cost_t, k),
        topk_iou=torch.topk(ious.transpose(1, 2), k, dim=-1).values)


def _check(scores, priors, decoded, gt_bboxes, gt_onehot, gt_valid, k):
    b, p = scores.shape
    g = gt_bboxes.shape[1]
    want = {"scores": (b, p), "priors": (p, 4), "decoded": (b, p, 4),
            "gt_bboxes": (b, g, 4), "gt_onehot": (b, g), "gt_valid": (b, g)}
    got = {"scores": scores, "priors": priors, "decoded": decoded,
           "gt_bboxes": gt_bboxes, "gt_onehot": gt_onehot,
           "gt_valid": gt_valid}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"streamed_simota: {name} has shape "
                             f"{tuple(got[name].shape)}, want {shape}")
    if p < k or g == 0:
        raise ValueError(f"streamed_simota: {p} priors and {g} GT slots; "
                         f"want at least k={k} priors and one slot")
    return b, p, g


def streamed_simota(scores: torch.Tensor, priors: torch.Tensor,
                    decoded: torch.Tensor, gt_bboxes: torch.Tensor,
                    gt_onehot: torch.Tensor, gt_valid: torch.Tensor, *,
                    center_radius: float = 2.5, k: int = 10,
                    iou_weight: float = 3.0, cls_weight: float = 1.0,
                    eps: float = 1e-7) -> StreamedAssign:
    """Batched streaming SimOTA reductions. scores (B, P) fused
    probabilities (single foreground class); priors (P, 4) shared and
    already offset by +0.5*stride; decoded (B, P, 4) xyxy; gt_bboxes
    (B, G, 4); gt_onehot (B, G) the label-0 one-hot column; gt_valid
    (B, G) bool. The plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    bsz, p, g = _check(scores, priors, decoded, gt_bboxes, gt_onehot,
                       gt_valid, k)
    kw = dict(center_radius=center_radius, k=k, iou_weight=iou_weight,
              cls_weight=cls_weight, eps=eps)
    if scores.device.type == "cpu":
        return streamed_simota_plain(scores, priors, decoded, gt_bboxes,
                                     gt_onehot, gt_valid, **kw)
    if scores.device.type != "cuda":
        raise ValueError(f"streamed_simota: no kernel for {scores.device}")
    ins = (scores, priors, decoded, gt_bboxes, gt_onehot)
    if any(t.dtype != torch.float32 for t in ins) or \
            gt_valid.dtype != torch.bool:
        raise TypeError("streamed_simota: f32 inputs and a bool gt_valid")
    if any(t.device != scores.device or not t.is_contiguous()
           for t in ins + (gt_valid,)):
        raise ValueError("streamed_simota: inputs must be contiguous on "
                         "one device")
    lib = LIB.get()
    if not 1 <= k <= lib.yunet_simota_max_k():
        raise ValueError(f"streamed_simota: k={k} outside the kernel's "
                         f"1..{lib.yunet_simota_max_k()}")
    if lib.yunet_simota_smem_bytes(g) > MAX_STATIC_SMEM:
        raise ValueError(f"streamed_simota: {g} GT slots do not fit the "
                         "kernel's shared memory")
    dev = scores.device
    valid = torch.empty((bsz, p), dtype=torch.uint8, device=dev)
    best = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    cand = torch.empty((bsz, g, k), dtype=torch.int32, device=dev)
    topk = torch.empty((bsz, g, k), dtype=torch.float32, device=dev)
    if bsz:
        ptrs = [t.data_ptr() for t in ins] + [
            gt_valid.view(torch.uint8).data_ptr()]
        consts = [float(center_radius), float(iou_weight),
                  float(cls_weight), float(eps)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.yunet_simota_valid_best(
                *ptrs, bsz, p, g, *consts, valid.data_ptr(),
                best.data_ptr(), stream)
            check_cuda_status(lib, code, "streamed_simota (valid_best)")
            streamed_simota.launches += 1
            code = lib.yunet_simota_topk(
                *ptrs, valid.data_ptr(), bsz, p, g, k, *consts,
                cand.data_ptr(), topk.data_ptr(), stream)
            check_cuda_status(lib, code, "streamed_simota (topk)")
            streamed_simota.launches += 1
    return StreamedAssign(valid.bool(), best, cand, topk)


streamed_simota.launches = 0
