"""Loss primitives: BCE with logits, BCE on probabilities, SmoothL1, EIoU
— counterpart of ``yunet_tpu/ops/losses.py``.

Elementwise forms; the train step composes the reduction and weights.
Each is spelled with the JAX package's formula (not torch's fused
``F.binary_cross_entropy_with_logits``), so the two agree to the ulp on
the CPU.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """max(l, 0) - l*t + log1p(exp(-|l|)), elementwise."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities with torch's log clamp at -100
    (F.binary_cross_entropy semantics; the SimOTA cls cost)."""
    log_p = torch.clamp(torch.log(probs), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-probs), min=-100.0)
    return -(targets * log_p + (1.0 - targets) * log_1mp)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def eiou(pred: torch.Tensor, target: torch.Tensor, *,
         smooth_point: float = 0.1, eps: float = 1e-6) -> torch.Tensor:
    """Extended-IoU loss over (..., 4) xyxy boxes (reference
    iou_loss.py:194-227): an extent/intersection IoU', then
    0.5*x^2/sp if x < sp else x - 0.5*sp, with x = 1 - IoU'. The branch
    selector is detached, as the JAX stop_gradient does."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)

    ex1 = torch.minimum(px1, tx1)
    ey1 = torch.minimum(py1, ty1)
    ix1 = torch.maximum(px1, tx1)
    iy1 = torch.maximum(py1, ty1)
    ix2 = torch.minimum(px2, tx2)
    iy2 = torch.minimum(py2, ty2)
    xmin = torch.minimum(ix1, ix2)
    ymin = torch.minimum(iy1, iy2)
    xmax = torch.maximum(ix1, ix2)
    ymax = torch.maximum(iy1, iy2)

    inter = ((ix2 - ex1) * (iy2 - ey1) + (xmin - ex1) * (ymin - ey1)
             - (ix1 - ex1) * (ymax - ey1) - (xmax - ex1) * (iy1 - ey1))
    union = ((px2 - px1) * (py2 - py1) + (tx2 - tx1) * (ty2 - ty1)
             - inter + eps)
    x = 1.0 - inter / union
    sign = (x < smooth_point).to(x.dtype).detach()
    return (0.5 * sign * x * x / smooth_point
            + (1.0 - sign) * (x - 0.5 * smooth_point))
