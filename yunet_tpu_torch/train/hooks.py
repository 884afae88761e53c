"""Training-time observability hooks — a copy of
``yunet_tpu/train/hooks.py`` (numpy; AugDump imports cv2 when it draws).

Host-side counterparts of the reference's auxiliary hooks:
  SampleSizeStatistics — histogram of post-augmentation GT face sizes
    (core/hook/yunet_sample_size_statistics_hook.py:9-63), the tool used to
    audit RandomSquareCrop's scale distribution;
  AugDump — writes augmented training images with boxes/landmarks drawn
    (core/utils/yunet_hook.py:9-72, 'WWHook');
  MemoryProfiler — periodic RSS logging
    (core/hook/memory_profiler_hook.py:6-55).

All operate on host (numpy) batch dicts.
"""

from __future__ import annotations

import json
import os
import resource
from typing import Dict, Optional

import numpy as np


class SampleSizeStatistics:
    """Accumulate sqrt-area histogram of GT boxes actually seen."""

    def __init__(self, bins=(0, 4, 8, 16, 32, 64, 128, 256, 512, 1024)):
        self.bins = np.asarray(bins, np.float32)
        self.counts = np.zeros(len(bins) - 1, np.int64)
        self.total = 0

    def update(self, batch: Dict[str, np.ndarray]) -> None:
        boxes = np.asarray(batch["gt_bboxes"])
        valid = np.asarray(batch["gt_valid"])
        wh = np.sqrt(np.clip(
            (boxes[..., 2] - boxes[..., 0]) *
            (boxes[..., 3] - boxes[..., 1]), 0, None))[valid]
        h, _ = np.histogram(wh, self.bins)
        self.counts += h
        self.total += int(valid.sum())

    def summary(self) -> Dict[str, int]:
        return {f"{int(self.bins[i])}-{int(self.bins[i + 1])}":
                int(self.counts[i]) for i in range(len(self.counts))}

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"total": self.total, "hist": self.summary()}, f,
                      indent=2)


class AugDump:
    """Dump augmented images with boxes/landmarks for visual debugging."""

    def __init__(self, out_dir: str, max_images: int = 64):
        self.out_dir = out_dir
        self.max_images = max_images
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, batch: Dict[str, np.ndarray]) -> None:
        import cv2

        imgs = np.asarray(batch["image"])
        boxes = np.asarray(batch["gt_bboxes"])
        kps = np.asarray(batch["gt_kps"])
        valid = np.asarray(batch["gt_valid"])
        for b in range(imgs.shape[0]):
            if self.n >= self.max_images:
                return
            img = np.clip(imgs[b], 0, 255).astype(np.uint8).copy()
            for g in np.where(valid[b])[0]:
                x1, y1, x2, y2 = boxes[b, g].astype(int)
                cv2.rectangle(img, (x1, y1), (x2, y2), (0, 0, 255), 2)
                for k in range(kps.shape[2]):
                    if kps[b, g, k, 2] > 0:
                        cv2.circle(img, tuple(kps[b, g, k, :2].astype(
                            int)), 2, (255, 0, 0), -1)
            cv2.imwrite(os.path.join(self.out_dir,
                                     f"aug_{self.n:05d}.jpg"), img)
            self.n += 1


class MemoryProfiler:
    """Max-RSS snapshot (MB) for periodic logging."""

    @staticmethod
    def rss_mb() -> float:
        kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return kb / 1024.0

    @staticmethod
    def available_mb() -> Optional[float]:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            return None
        return None
