"""Host routines in C++: exact greedy NMS (the default NMS of
``Detector.detect``) and the WIDER per-image matcher of
``eval/widerface.py`` — counterparts of ``yunet_tpu/native/__init__.py``.

Builds ``csrc/host_nms.cpp`` (a copy of the JAX package's
``yunet_tpu/native/yunet_ops.cpp``, held byte-equal to it by a test) with
``g++`` into ``yunet_tpu_torch/_build/`` at first use. If the build fails,
this raises: there is no slower fallback that would hide it.
``_wider_match_numpy`` is the matcher's plain version, for the tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from .ops._build import CSRC_DIR, GXX_FLAGS, NativeLib

SOURCE = os.path.join(CSRC_DIR, "host_nms.cpp")
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
LIB = NativeLib(
    SOURCE, ["g++"] + GXX_FLAGS,
    {"nms_f32": (ctypes.c_int, [_FP, _FP, ctypes.c_int, ctypes.c_float,
                                _IP]),
     "wider_match": (None, [_FP, ctypes.c_int, _FP, ctypes.c_int, _IP,
                            ctypes.c_float, _IP, _IP])})


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_thr: float) -> np.ndarray:
    """Exact greedy NMS (suppress when IoU > iou_thr, mmcv's C++ op).
    boxes (n, 4) xyxy, scores (n,). Returns kept indices, score-desc."""
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError(f"boxes {boxes.shape} / scores {scores.shape}")
    if n == 0:
        return np.zeros((0,), np.int64)
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty((n,), np.int32)
    m = LIB.get().nms_f32(boxes.ctypes.data_as(_FP),
                          scores.ctypes.data_as(_FP), n,
                          ctypes.c_float(iou_thr), keep.ctypes.data_as(_IP))
    return keep[:m].astype(np.int64)


def wider_match(preds: np.ndarray, gts: np.ndarray, keep_mask: np.ndarray,
                iou_thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image WIDER matching (the official tool's legacy +1 IoU).
    preds (N, 5) xywh + score (score-desc), gts (M, 4) xywh, keep_mask
    (M,) int (1 = evaluated). Returns (pred_recall (N,), proposal (N,))
    int32: the running count of claimed evaluated faces, and 1 for a
    proposal or -1 for a prediction that matched an ignored face."""
    n, m = preds.shape[0], gts.shape[0]
    if preds.shape != (n, 5) or gts.shape != (m, 4) or \
            keep_mask.shape != (m,):
        raise ValueError(f"preds {preds.shape} / gts {gts.shape} / "
                         f"keep_mask {keep_mask.shape}")
    preds = np.ascontiguousarray(preds, np.float32)
    gts = np.ascontiguousarray(gts, np.float32)
    keep_mask = np.ascontiguousarray(keep_mask, np.int32)
    pred_recall = np.empty((n,), np.int32)
    proposal = np.empty((n,), np.int32)
    LIB.get().wider_match(preds.ctypes.data_as(_FP), n,
                          gts.ctypes.data_as(_FP), m,
                          keep_mask.ctypes.data_as(_IP),
                          ctypes.c_float(iou_thr),
                          pred_recall.ctypes.data_as(_IP),
                          proposal.ctypes.data_as(_IP))
    return pred_recall, proposal


def _wider_match_numpy(preds, gts, keep_mask, iou_thr):
    """wider_match's plain version (yunet_tpu/native/__init__.py:133), in
    f64."""
    n, m = preds.shape[0], gts.shape[0]
    p = preds.astype(np.float64)
    g = gts.astype(np.float64)
    px2, py2 = p[:, 0] + p[:, 2], p[:, 1] + p[:, 3]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    parea = (px2 - p[:, 0] + 1) * (py2 - p[:, 1] + 1)
    garea = (gx2 - g[:, 0] + 1) * (gy2 - g[:, 1] + 1)
    iw = (np.minimum(px2[:, None], gx2) - np.maximum(p[:, None, 0], g[:, 0])
          + 1)
    ih = (np.minimum(py2[:, None], gy2) - np.maximum(p[:, None, 1], g[:, 1])
          + 1)
    inter = iw * ih
    iou = inter / (parea[:, None] + garea - inter)
    iou[(iw <= 0) | (ih <= 0)] = 0
    best = iou.argmax(axis=1)
    best_ov = iou[np.arange(n), best]
    recall_list = np.zeros((m,), np.int8)
    pred_recall = np.zeros((n,), np.int32)
    proposal = np.ones((n,), np.int32)
    claimed = 0
    for h in range(n):
        if best_ov[h] >= iou_thr:
            k = best[h]
            if keep_mask[k] == 0:
                recall_list[k] = -1
                proposal[h] = -1
            elif recall_list[k] == 0:
                recall_list[k] = 1
                claimed += 1
        pred_recall[h] = claimed
    return pred_recall, proposal
