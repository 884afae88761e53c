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

The kernel orders (cost, prior index) pairs and IoUs by one integer key
each; ``ordered_bits``, ``cost_keys``, ``iou_keys`` and ``iou_from_key``
are those keys written out in numpy, for the CPU model of its selection
(``tests/test_torch_simota_select.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..utils.profiling import span
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
        yunet_simota_topk=[_P] * 7 + [_I] * 4 + [_F] * 4 + [_P] * 3,
        yunet_simota=[_P] * 6 + [_I] * 4 + [_F] * 4 + [_P] * 5),
     "yunet_simota_smem_bytes": (ctypes.c_size_t, [_I]),
     "yunet_simota_max_k": (_I, [])})
MAX_STATIC_SMEM = 48 * 1024


class _EntryPoints(NamedTuple):
    lib: ctypes.CDLL
    launch: object      # yunet_simota: both launches in one call
    max_k: int


@functools.lru_cache(maxsize=None)
def _entry_points() -> _EntryPoints:
    """The built library's entry point, resolved once (no lock or
    attribute lookup on the per-call path)."""
    lib = LIB.get()
    return _EntryPoints(lib, lib.yunet_simota, lib.yunet_simota_max_k())


@functools.lru_cache(maxsize=None)
def _smem_fits(g: int) -> bool:
    return _entry_points().lib.yunet_simota_smem_bytes(g) <= MAX_STATIC_SMEM


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


def ordered_bits(values) -> np.ndarray:
    """The uint32 by which the kernel orders f32 values
    (``csrc/simota.cu:ordered_bits``): the unsigned order of the results
    is the float order of the values, and -0 and +0 give one result. No
    NaN is expected."""
    v = np.asarray(values, np.float32)
    u = np.where(v == 0, np.float32(0), v).view(np.uint32)
    return np.where(u >> 31 != 0, ~u, u | np.uint32(0x80000000))


def cost_keys(cost, index) -> np.ndarray:
    """uint64 keys whose ascending order is the (cost, prior index) order
    of the stable sort in ``topk_min_idx``: the cost's ordered bits over
    the index."""
    return ((ordered_bits(cost).astype(np.uint64) << np.uint64(32))
            | np.asarray(index).astype(np.uint64))


def iou_keys(iou, index) -> np.ndarray:
    """uint64 keys whose ascending order is descending IoU, ties to the
    lower prior index: the complement of the IoU's ordered bits over the
    index."""
    return (((~ordered_bits(iou)).astype(np.uint64) << np.uint64(32))
            | np.asarray(index).astype(np.uint64))


def iou_from_key(keys) -> np.ndarray:
    """The f32 IoU an ``iou_keys`` key holds (+0 for a zero), and 0 for
    the no-key value 2**64 - 1 (the kernel keys IoUs above 0 only and pads
    its top k with zeros)."""
    keys = np.asarray(keys, np.uint64)
    u = ~(keys >> np.uint64(32)).astype(np.uint32)
    iou = np.where(u >> 31 != 0, u & np.uint32(0x7fffffff),
                   ~u).astype(np.uint32).view(np.float32)
    return np.where(keys == np.uint64(2 ** 64 - 1), np.float32(0), iou)


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


_NAMES = ("scores", "priors", "decoded", "gt_bboxes", "gt_onehot",
          "gt_valid")


def _check(scores, priors, decoded, gt_bboxes, gt_onehot, gt_valid, k):
    b, p = scores.shape
    g = gt_bboxes.shape[1]
    want = ((b, p), (p, 4), (b, p, 4), (b, g, 4), (b, g), (b, g))
    got = (scores.shape, priors.shape, decoded.shape, gt_bboxes.shape,
           gt_onehot.shape, gt_valid.shape)
    if got != want:
        name, have, shape = next(x for x in zip(_NAMES, got, want)
                                 if x[1] != x[2])
        raise ValueError(f"streamed_simota: {name} has shape "
                         f"{tuple(have)}, want {shape}")
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
    (B, G) bool; gt_onehot in [0, 1]. The plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (no fallback between them).

    On the card the host's part of a call (the checks, four allocations
    and one ctypes call that makes both launches) took about as long as
    the device's at the training shapes (PERF.md §6, K1), so the path
    here resolves the library once and makes no launch of its own. The
    kernel costs only the pairs that can reach an output (see
    ``csrc/simota.cu``), which needs the weights checked below."""
    args = (scores, priors, decoded, gt_bboxes, gt_onehot, gt_valid,
            center_radius, k, iou_weight, cls_weight, eps)
    if not _autograd_profiler._is_profiler_enabled:     # no span to open
        return _streamed_simota(*args)
    with span("yunet.k1"):
        return _streamed_simota(*args)


def _streamed_simota(scores, priors, decoded, gt_bboxes, gt_onehot,
                     gt_valid, center_radius, k, iou_weight, cls_weight,
                     eps):
    bsz, p, g = _check(scores, priors, decoded, gt_bboxes, gt_onehot,
                       gt_valid, k)
    if scores.device.type == "cpu":
        return streamed_simota_plain(
            scores, priors, decoded, gt_bboxes, gt_onehot, gt_valid,
            center_radius=center_radius, k=k, iou_weight=iou_weight,
            cls_weight=cls_weight, eps=eps)
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
    # the kernel costs only the in-box-and-centre tier where that tier
    # decides (csrc/simota.cu); with these bounds its costs stay below INF
    if not (cls_weight >= 0 and iou_weight >= 0 and eps > 0 and 100 *
            cls_weight + iou_weight * max(-math.log(eps), 0.0) < INF / 2):
        raise ValueError("streamed_simota: the kernel needs cls_weight, "
                         "iou_weight >= 0 and eps > 0 small enough that "
                         "in-box-and-centre costs stay below INF")
    fns = _entry_points()
    if not 1 <= k <= fns.max_k:
        raise ValueError(f"streamed_simota: k={k} outside the kernel's "
                         f"1..{fns.max_k}")
    if not _smem_fits(g):
        raise ValueError(f"streamed_simota: {g} GT slots do not fit the "
                         "kernel's shared memory")
    dev = scores.device
    valid = torch.empty((bsz, p), dtype=torch.bool, device=dev)
    best = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    cand = torch.empty((bsz, g, k), dtype=torch.int32, device=dev)
    topk = torch.empty((bsz, g, k), dtype=torch.float32, device=dev)
    if bsz:
        args = [t.data_ptr() for t in ins] + [
            gt_valid.data_ptr(), bsz, p, g, k, center_radius, iou_weight,
            cls_weight, eps, valid.data_ptr(), best.data_ptr(),
            cand.data_ptr(), topk.data_ptr()]
        with (contextlib.nullcontext()
              if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            code = fns.launch(*args, torch.cuda.current_stream().cuda_stream)
        check_cuda_status(fns.lib, code, "streamed_simota")
        streamed_simota.launches += 2        # valid_best and topk
    return StreamedAssign(valid, best, cand, topk)


streamed_simota.launches = 0
