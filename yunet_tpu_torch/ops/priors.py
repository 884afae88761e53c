"""Anchor-free grid priors — a copy of ``yunet_tpu/ops/priors.py``.

`grid_priors` returns the concatenated multi-level prior table
(P, 4) = [x, y, stride_w, stride_h], where x = (col + offset) * stride and
rows are row-major over (row, col) per level — the head's flatten order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def grid_priors(featmap_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int], offset: float = 0.0,
                dtype=np.float32) -> np.ndarray:
    """Concatenated (P, 4) prior table for all levels."""
    levels: List[np.ndarray] = []
    for (h, w), stride in zip(featmap_sizes, strides):
        xs = (np.arange(w, dtype=dtype) + offset) * stride
        ys = (np.arange(h, dtype=dtype) + offset) * stride
        xx, yy = np.meshgrid(xs, ys)  # row-major: y outer, x inner
        sw = np.full((h * w,), stride, dtype=dtype)
        levels.append(
            np.stack([xx.reshape(-1), yy.reshape(-1), sw, sw], axis=-1))
    return np.concatenate(levels, axis=0)
