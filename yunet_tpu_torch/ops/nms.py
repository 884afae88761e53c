"""Greedy NMS on the device, whole batch and per image — counterpart of
``yunet_tpu/ops/nms_pallas.py`` (``pallas_nms_batched`` and
``pallas_nms``).

Both functions keep the JAX contract: a score mask, top-k in score order
(ties: lowest index first, as ``jax.lax.top_k``) and a box gather in plain
PyTorch, then greedy suppression at IoU > iou_thr over the candidates
above the score threshold. They return (dets (.., K, 5), keep (.., K) bool,
idx (.., K)).

The suppression step, ``greedy_nms_keep``, sends a CUDA tensor to the
hand-written kernel (``csrc/nms.cu``: an IoU bitmask of every pair in
parallel, then a one-warp greedy scan per image) and a CPU tensor to
``greedy_nms_keep_plain``, the same greedy loop in plain PyTorch. Both
give the same keep set bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "nms.cu")
# -fmad=false: the IoU must round exactly as the plain version's separate
# multiply and add do (the source also spells each rounding out)
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS + ["-fmad=false"],
    cuda_signatures(
        yunet_greedy_nms=[_P, _P, _I, _I, ctypes.c_float, _P, _P, _I, _P],
        # each launch alone, for timing them apart (chip_smoke.py)
        yunet_nms_mask=[_P, _P, _I, _I, ctypes.c_float, _P, _I, _P],
        yunet_nms_scan=[_P, _I, _I, _P, _P, _I, _P]))
# the most candidates an image the kernel takes (csrc/nms.cu:kMaxK; the
# scan's lanes hold at most 10 removed words each): every K that the
# earlier one-block-per-image kernel took, 24 B a candidate in 227 KB
MAX_K = 9685


def mask_words(k: int) -> int:
    """u32 words in a row of the kernel's scratch mask: ceil(k/32) rounded
    up to a multiple of 4, so that the scan copies rows 16 B at a time."""
    return ((k + 31) // 32 + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def _entry_point():
    """(library, yunet_greedy_nms), resolved once: no lock or attribute
    lookup on the per-call path."""
    lib = LIB.get()
    return lib, lib.yunet_greedy_nms


def greedy_nms_keep_plain(boxes: torch.Tensor, counts: torch.Tensor,
                          iou_thr: float) -> torch.Tensor:
    """The plain version. boxes (B, K, 4) f32 sorted by score per image;
    counts (B,) the number above the score threshold. Returns keep (B, K)
    bool. The arithmetic and its rounding follow nms_pallas.py:46-64."""
    bsz, k, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)                      # (B, K)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    col = torch.arange(k, device=boxes.device)
    counts = counts.to(torch.int64)
    thr = torch.tensor(iou_thr, dtype=torch.float32)
    suppressed = torch.zeros((bsz, k), dtype=torch.bool, device=boxes.device)
    for i in range(int(counts.max()) if bsz and k else 0):
        alive = ~suppressed[:, i:i + 1] & (i < counts[:, None])   # (B, 1)
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1]))
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1]))
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        union = torch.clamp(area + area[:, i:i + 1] - inter, min=1e-9)
        suppressed |= (inter / union > thr) & (col > i) & alive
    return ~suppressed & (col < counts[:, None])


def greedy_nms_keep(boxes: torch.Tensor, counts: torch.Tensor,
                    iou_thr: float) -> torch.Tensor:
    """Greedy suppression: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (no fallback between them).

    On the card the call is two launches (the mask and the scan) from one
    ctypes call, into a (B, K) bool keep and a (B, K, mask_words(K)) i32
    scratch mask that the kernel fills only where it needs."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            counts.shape != boxes.shape[:1]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / counts "
                         f"{tuple(counts.shape)}: want (B, K, 4) / (B,)")
    if boxes.device.type == "cpu":
        return greedy_nms_keep_plain(boxes, counts, iou_thr)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_nms_keep: no kernel for {boxes.device}")
    if boxes.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError("greedy_nms_keep: boxes must be f32 and counts i32")
    if counts.device != boxes.device or not (
            boxes.is_contiguous() and counts.is_contiguous()):
        raise ValueError("greedy_nms_keep: boxes and counts must be "
                         "contiguous on one device")
    bsz, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"greedy_nms_keep: {k} candidates per image; the "
                         f"kernel takes at most {MAX_K}")
    dev = boxes.device
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    if bsz and k:
        mask = torch.empty((bsz, k, mask_words(k)), dtype=torch.int32,
                           device=dev)
        lib, launch = _entry_point()
        code = launch(boxes.data_ptr(), counts.data_ptr(), bsz, k,
                      float(iou_thr), mask.data_ptr(), keep.data_ptr(),
                      dev.index, torch.cuda.current_stream(dev).cuda_stream)
        check_cuda_status(lib, code, "greedy_nms_keep")
        greedy_nms_keep.launches += 2        # the mask and the scan
    return keep


greedy_nms_keep.launches = 0


def topk_candidates(boxes: torch.Tensor, scores: torch.Tensor, top_k: int,
                    score_thr: float):
    """Score mask, top-k and gather (nms_pallas.py:137-151). A stable
    descending sort reproduces jax.lax.top_k's tie order."""
    k = min(top_k, scores.shape[-1])
    masked = torch.where(scores >= score_thr, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.sort(masked, dim=-1, descending=True,
                                 stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    top_boxes = torch.gather(boxes.float(), -2,
                             idx[..., None].expand(*idx.shape, 4))
    counts = (top_scores >= score_thr).sum(-1, dtype=torch.int32)
    return top_boxes, top_scores, idx, counts


def device_nms_batched(boxes: torch.Tensor, scores: torch.Tensor, *,
                       top_k: int, iou_thr: float = 0.45,
                       score_thr: float = 0.02
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched greedy NMS: boxes (B, P, 4), scores (B, P) -> per image
    dets (B, K, 5), keep (B, K) bool, idx (B, K), K = min(top_k, P)."""
    top_boxes, top_scores, idx, counts = topk_candidates(
        boxes, scores, top_k, score_thr)
    top_boxes = top_boxes.contiguous()
    keep = greedy_nms_keep(top_boxes, counts, iou_thr)
    dets = torch.cat([top_boxes, top_scores[..., None]], dim=-1)
    return dets, keep, idx


def device_nms(boxes: torch.Tensor, scores: torch.Tensor, *, top_k: int,
               iou_thr: float = 0.45, score_thr: float = 0.02):
    """Per-image greedy NMS: boxes (P, 4), scores (P,) -> dets (K, 5),
    keep (K,) bool, idx (K,) — the batch-1 case of the same kernel."""
    dets, keep, idx = device_nms_batched(
        boxes[None], scores[None], top_k=top_k, iou_thr=iou_thr,
        score_thr=score_thr)
    return dets[0], keep[0], idx[0]
