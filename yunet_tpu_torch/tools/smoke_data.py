"""Synthetic data source for --smoke runs (no dataset) — a copy of
``tools/smoke_data.py``: the same numpy batch from the same seed."""

import numpy as np

from ..config import Config


class SyntheticLoader:
    def __init__(self, cfg: Config, *, batch_size: int, seed: int = 0):
        self.cfg = cfg
        rng = np.random.RandomState(seed)
        s = cfg.data.img_size
        g = cfg.data.max_gts
        b = batch_size
        c = rng.uniform(40, s - 40, (b, g, 2)).astype(np.float32)
        wh = rng.uniform(16, 120, (b, g, 2)).astype(np.float32)
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        kps = np.zeros((b, g, 5, 3), np.float32)
        kps[..., 0] = rng.uniform(40, s - 40, (b, g, 5))
        kps[..., 1] = rng.uniform(40, s - 40, (b, g, 5))
        kps[..., 2] = 1.0
        self.batch = {
            "image": rng.randint(0, 256, (b, s, s, 3)).astype(np.float32),
            "gt_bboxes": boxes,
            "gt_labels": np.zeros((b, g), np.int32),
            "gt_kps": kps,
            "gt_valid": np.tile(np.arange(g) < 6, (b, 1)),
        }
        self.steps_per_epoch = 1000

    def __iter__(self):
        while True:
            yield dict(self.batch)

    def close(self):
        pass
