"""WIDER Face training dataset: load -> augment -> fixed-shape sample — a
copy of ``yunet_tpu/data/dataset.py``. With a decoded ``.npy`` cache an
image is read from it; an image missing from it is decoded from its JPEG
with OpenCV, as in JAX. OpenCV is imported only for that decode, so on a
host without it (the card host) a cache miss raises ImportError.

Replaces the reference's RetinaFaceDataset + pipeline + DataContainer
collate (datasets/retinaface.py, datasets/builder.py:80-230): instead of
dynamic per-image tensors batched through DataContainers, every sample is
padded to a static ``max_gts`` so batches are plain stacked arrays that jit
can consume without recompilation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .labelv2 import NK, Record, parse_labelv2
from .transforms import (horizontal_flip, random_square_crop,
                         resize_with_targets)


@dataclass
class SampleSpec:
    img_size: int = 640
    max_gts: int = 128
    crop_choice: Sequence[float] = (0.5, 0.7, 0.9, 1.1, 1.3, 1.5)
    flip_ratio: float = 0.5


class WiderFaceDataset:
    def __init__(self, ann_file: str, img_prefix: str, spec: SampleSpec,
                 *, min_size: Optional[float] = None,
                 test_mode: bool = False,
                 decoded_cache: Optional[str] = None,
                 reduced_decode: bool = False):
        """decoded_cache: dir of raw .npy images (data/cache.py) — loads
        become mmaps and the crop touches only the pages it reads.
        reduced_decode: when loading JPEGs whose crop will be downscaled
        anyway, decode at 1/2-1/8 resolution (libjpeg scaled decode) —
        same output resolution, a fraction of the decode cost."""
        self.records: List[Record] = parse_labelv2(
            ann_file, min_size=min_size, test_mode=test_mode)
        self.img_prefix = img_prefix
        self.spec = spec
        self.test_mode = test_mode
        self.decoded_cache = decoded_cache
        self.reduced_decode = reduced_decode

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, rec: Record, reduction: int = 1) -> np.ndarray:
        if self.decoded_cache is not None:
            from .cache import load_cached
            img = load_cached(self.decoded_cache, rec.filename)
            if img is not None:
                return img
        import cv2

        path = os.path.join(self.img_prefix, rec.filename)
        if reduction > 1:
            from .cache import reduced_imread
            img = reduced_imread(path, reduction)
        else:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def get_train_sample(self, idx: int,
                         rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        # Pre-draw the crop scale (same rng stream as drawing it inside
        # random_square_crop) so the decode reduction can be chosen before
        # the image is read.
        scale = float(rng.choice(self.spec.crop_choice))
        reduction = 1
        if self.reduced_decode and self.decoded_cache is None:
            from .cache import pick_reduction
            # random_square_crop may REDRAW the scale after 250 failed
            # placements: with max(crop_choice) <= 1.0 the scale only
            # grows (x1.2), so the drawn scale is the minimum; otherwise
            # a redraw samples the full choice list, so the reduction
            # must stay valid for the smallest possible scale or the
            # crop would be under-resolved (transforms.py:51-55)
            floor_scale = (scale if max(self.spec.crop_choice) <= 1.0
                           else min(self.spec.crop_choice))
            reduction = pick_reduction(min(rec.width, rec.height),
                                       floor_scale, self.spec.img_size)
        # keep uint8 (possibly an mmap) through the crop: the canvas paste
        # reads only the crop window, and the uint8 resize matches the
        # reference pipeline (mmcv resizes uint8; Normalize is identity)
        img = self.load_image(rec, reduction)
        boxes, kps, ign = rec.bboxes, rec.kps, rec.bboxes_ignore
        if reduction > 1:
            sy = img.shape[0] / rec.height
            sx = img.shape[1] / rec.width
            s4 = np.asarray([sx, sy, sx, sy], np.float32)
            boxes = boxes * s4
            ign = ign * s4 if ign.size else ign
            kps = kps.copy()
            kps[:, :, 0] *= sx
            kps[:, :, 1] *= sy
        img, boxes, kps, ign = random_square_crop(
            img, boxes, kps, ign, self.spec.crop_choice, rng, scale=scale)
        img, boxes, kps, ign = resize_with_targets(
            img, boxes, kps, ign,
            (self.spec.img_size, self.spec.img_size))
        if rng.uniform() < self.spec.flip_ratio:
            img, boxes, kps, ign = horizontal_flip(img, boxes, kps, ign)
        return pack_sample(img, boxes, kps, self.spec.max_gts)


def pack_sample(img: np.ndarray, boxes: np.ndarray, kps: np.ndarray,
                max_gts: int) -> Dict[str, np.ndarray]:
    """Pad GT arrays to a static size. Overflow keeps the largest faces
    (the dropped tail is tiny crowd boxes; count is reported so training
    can monitor truncation)."""
    n = boxes.shape[0]
    if n > max_gts:
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = np.argsort(-area, kind="stable")[:max_gts]
        boxes, kps = boxes[keep], kps[keep]
        overflow = n - max_gts
        n = max_gts
    else:
        overflow = 0
    out_boxes = np.zeros((max_gts, 4), np.float32)
    out_kps = np.zeros((max_gts, NK, 3), np.float32)
    out_boxes[:n] = boxes
    out_kps[:n] = kps
    # ship uint8 when the pipeline kept it: 4x less host->device traffic
    # and the device casts straight to bf16 (0..255 is exact in bf16);
    # float augs (e.g. photometric) still flow through as f32
    img_dtype = np.uint8 if img.dtype == np.uint8 else np.float32
    return {
        "image": np.ascontiguousarray(img, img_dtype),
        "gt_bboxes": out_boxes,
        "gt_labels": np.zeros((max_gts,), np.int32),
        "gt_kps": out_kps,
        "gt_valid": (np.arange(max_gts) < n),
        "num_overflow": np.int32(overflow),
    }


def pack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
