"""LR schedule: linear warmup + epoch-step decay (+ linear batch scaling)
— counterpart of ``yunet_tpu/train/lr.py``.

Reference recipe (configs/yunet_n.py:1-12): SGD lr 0.01 at global batch
32, linear warmup over 1500 iterations from ratio 0.001, x0.1 step decay
at epochs 400 and 544 (of 640). mmcv's warmup multiplier:
1 - (1 - iter/warmup_iters) * (1 - warmup_ratio).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def scale_lr(base_lr: float, total_batch: int, base_batch: int = 32) -> float:
    """Linear LR scaling rule (reference auto_scale_lr semantics)."""
    return base_lr * total_batch / base_batch


def lr_schedule(base_lr: float, *, steps_per_epoch: int, warmup_iters: int,
                warmup_ratio: float, decay_epochs: Sequence[int],
                decay_factor: float) -> Callable[[int], float]:
    """Returns step -> lr, a plain Python function (float64; the JAX
    schedule computes the same expression in float32)."""
    decay_epochs = tuple(decay_epochs)

    def sched(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        lr = base_lr * decay_factor ** sum(epoch >= e for e in decay_epochs)
        if step >= warmup_iters:
            return lr
        frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        return lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))

    return sched
