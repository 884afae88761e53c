"""EMA weight shadowing — counterpart of ``yunet_tpu/train/ema.py``
(reference core/hook/ema.py:8-130):

  ema = (1 - m(t)) * ema + m(t) * param, with the exponential-momentum
  warmup m(t) = (1 - m0) * exp(-(1 + t) / total_iter) + m0, or the linear
  one m(t) = min(m0^interval, (1 + t) / (warm_up + t)).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def exp_momentum(m0: float, total_iter: int = 2000
                 ) -> Callable[[float], float]:
    def fn(step: float) -> float:
        return (1.0 - m0) * math.exp(-(1.0 + step) / total_iter) + m0
    return fn


def linear_momentum(m0: float, warm_up: int = 100,
                    interval: int = 1) -> Callable[[float], float]:
    def fn(step: float) -> float:
        return min(m0 ** interval, (1.0 + step) / (warm_up + step))
    return fn


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               momentum: float) -> None:
    """ema <- ema * (1 - m) + params * m, in place, tensor by tensor."""
    for e, p in zip(ema, params):
        e.copy_(e * (1.0 - momentum) + p.to(e.dtype) * momentum)
