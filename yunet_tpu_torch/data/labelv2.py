"""SCRFD labelv2 annotation parser — a copy of
``yunet_tpu/data/labelv2.py`` (numpy only).

Format (reference mmdet/datasets/retinaface.py:29-100; sample at
data/widerface/labelv2/val/labelv2.txt):

  # <relative/path.jpg> <width> <height>
  x1 y1 x2 y2 [kp0x kp0y kp0v ... kp4x kp4y kp4v] [ignore_flag]

Keypoint visibility: a row of all -1 -> weight 0 (invisible); otherwise the
third value must be >= 0 and the weight becomes 1. A 5-value line's fifth
value == 1 marks the face ignored. Faces smaller than ``min_size`` are
moved to the ignore list. Images with zero usable faces are dropped in
train mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

NK = 5


@dataclass
class Record:
    filename: str
    width: int
    height: int
    bboxes: np.ndarray          # (n, 4) xyxy f32
    labels: np.ndarray          # (n,) int64 (all 0: 'FG')
    kps: np.ndarray             # (n, NK, 3) f32, col 2 = weight {0, 1}
    bboxes_ignore: np.ndarray   # (k, 4) f32


def _parse_face_line(values: List[float], min_size: Optional[float]):
    bbox = np.asarray(values[0:4], np.float32)
    kps = np.zeros((NK, 3), np.float32)
    ignore = False
    if min_size is not None:
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        if w < min_size or h < min_size:
            ignore = True
    if len(values) > 5:
        kps = np.asarray(values[4:4 + NK * 3], np.float32).reshape(NK, 3)
        for i in range(NK):
            if np.all(kps[i] == -1):
                kps[i, 2] = 0.0
            else:
                kps[i, 2] = 1.0
    elif len(values) == 5:
        ignore = ignore or (values[4] == 1)
    return bbox, kps, ignore


def parse_labelv2(path: str, *, min_size: Optional[float] = None,
                  test_mode: bool = False) -> List[Record]:
    images = []
    current = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                name, w, h = line[1:].split()
                current = {"filename": name, "width": int(w),
                           "height": int(h), "faces": []}
                images.append(current)
            else:
                assert current is not None, "face line before image header"
                values = [float(v) for v in line.split()]
                current["faces"].append(
                    _parse_face_line(values, min_size))

    records: List[Record] = []
    for img in images:
        keep, ign = [], []
        for bbox, kps, ignore in img["faces"]:
            (ign if ignore else keep).append((bbox, kps))
        if not keep and not test_mode:
            continue
        bboxes = (np.stack([b for b, _ in keep])
                  if keep else np.zeros((0, 4), np.float32))
        kpss = (np.stack([k for _, k in keep])
                if keep else np.zeros((0, NK, 3), np.float32))
        bboxes_ignore = (np.stack([b for b, _ in ign])
                         if ign else np.zeros((0, 4), np.float32))
        records.append(Record(
            filename=img["filename"], width=img["width"],
            height=img["height"], bboxes=bboxes,
            labels=np.zeros((bboxes.shape[0],), np.int64),
            kps=kpss, bboxes_ignore=bboxes_ignore))
    return records
