"""Exact host greedy NMS — the default NMS of ``Detector.detect`` —
counterpart of ``yunet_tpu/native/__init__.py:71-89``.

Builds the JAX package's C++ source (``yunet_tpu/native/yunet_ops.cpp``)
by path with ``g++`` into ``yunet_tpu_torch/_build/`` at first use; it
does not import ``yunet_tpu``. If the build fails, this raises: there is
no slower fallback that would hide it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .ops._build import GXX_FLAGS, PKG_DIR, NativeLib

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "yunet_tpu", "native",
                      "yunet_ops.cpp")
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
LIB = NativeLib(
    SOURCE, ["g++"] + GXX_FLAGS,
    {"nms_f32": (ctypes.c_int, [_FP, _FP, ctypes.c_int, ctypes.c_float,
                                _IP])})


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
